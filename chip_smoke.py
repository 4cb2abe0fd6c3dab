#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA H100 and check it.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit; nothing is caught):

  1. card   — print the card's name and power limit; TF32 off.
  2. build  — compile the paths' CUDA kernels from src/repro_torch (one
              nvcc per source, all started together, on a thread of their
              own while phases 13-15 run on the card), then count each
              kernel's tensor-core (HGMMA, HMMA), asynchronous-copy
              (UTMALDG, LDGSTS) and mbarrier (SYNCS) instructions in
              ``cuobjdump -sass``: each of the bf16 flash kernel's four
              instantiations (hd 64, 80, 112, 128) must have all three,
              and none may spill; each of the cc flash kernel's twelve
              (f32 and bf16 at hd 16-128) must have HMMA (mma.sync in
              TF32 parts) and LDGSTS (cp.async) and no spills, printed
              with its registers, key tile, dynamic shared bytes and
              blocks per SM.
  3. kernel — hold ``consensus_round`` against its plain PyTorch version on
              the card at three shapes in working dtypes, with real qwen3-4b
              leaf structure: J=2/deg=1 bf16 native wire (one full-width
              layer, ~101M elements per row), the same with an int8 wire,
              and J=4/deg=2 (one layer's attention, ~26M per row).
  4. slice  — ``launch.train.run`` on qwen3-4b at full width (d_model 2560,
              32/8 heads, head_dim 128, d_ff 9728, vocab 151,936, untied
              head) with depth cut from 36 to 4 layers, so that two node
              replicas with bf16 params, f32 AdamW moments and the f32 dual
              and neighbor-mean buffers fit in 80 GB: 2 nodes, nap, ring,
              2 local steps, 8 steps (4 consensus rounds), 4 x 512 tokens
              per node, AdamW lr 3e-4. Every round must launch the kernel.
              The run is traced with torch.profiler (CUDA activity): the
              kernel's time in each round, the device's idle share and its
              time by kernel family come from that trace.
  4b. agree — the reduced qwen3-4b trainer in float32 on the card against
              the same trainer on the CPU from the same weights (the CPU
              path is the one the tests hold against the JAX reference).
  5. full   — the kernel at the slice's own shape (1,181,941,760 elements
              per row) against the plain version run in block-aligned
              column chunks (whole, its f32 temporaries do not fit).
  6. masked — the edge-gated kernel against its plain version at one
              full-width layer's row (~101M elements): J=4, offsets 1, 2, 3,
              bf16 native wire, gates mixed 0/1 with a ghost row (inv_deg 0)
              and an offset dead for every node, with and without non-zero
              kicks on gated edges, and once with an int8 wire. theta', lam'
              and bar must equal the plain version's bit for bit.
  7. dyn    — the dynamic-topology path: ``launch.train.run`` on qwen3-4b at
              full width with depth cut from 36 to 1 layer, 3 nodes on a ring
              (offsets 1, 2), nap, the budget scheduler, node 1 dropped after
              step 3, 2 local steps, 8 steps, 4 x 512 tokens per node, lr
              3e-4, under torch.profiler. Every round must launch the gated
              kernel once and the ungated one never; node 1 is a ghost after
              step 3 and the active edge fraction falls from 1.00 to 2/6.
  7b. dagree — the reduced float32 trainer on the card against the CPU on a
              dynamic topology: J=4, complete, round_robin with churn, node 1
              dropped after step 3, so that edges gate and non-zero kicks
              reach the kernel.
  8. dfull  — the gated kernel at the dynamic slice's own shape (J=3,
              offsets 1, 2, one layer's row) with kicks, against the plain
              version in column chunks.
  9. flash  — the flash attention kernels against their plain version on
              the card: bf16 at head dim 128 goes to the tensor-core
              (wgmma) kernel, float32 and bf16 at hd 16 and 32 to the cc
              one (mma.sync in TF32 parts; ``kernels.flash_attention
              .route``). Each case is timed beside its bound, the cc kernel
              on the same inputs (ungated), the plain version and the
              library's scaled_dot_product_attention: the serve path's
              shape (one full-width qwen3-4b layer after the model's K/V
              repeat: B 4, S 512, 32 heads, hd 128, bf16, causal; the
              tensor-core kernel must take at most 2.5x the library's time
              there), the GQA index path (8 KV heads), a sliding window of
              256, the path's shape in float32 (bound: three TF32 products
              a term at the TF32 rate, printed beside the f32-rate bound),
              and bf16 at hd 16 and 32 on the cc kernel's own route; at
              the path's shape also through ``ops.flash_attention`` in the
              model layout [B, S, H, hd], as the serve path calls it.
 10. scan   — the RWKV6 scan kernel against its plain version at one
              rwkv6-7b layer (B 4, T 512, 64 heads of 64, chunk 32), float32
              and bf16, timed beside its bound, with its blocks per (batch,
              head), shared bytes per block and blocks per SM.
              Kernel times in phases 9 and 10 are device times: the
              launches queue behind a device-side sleep, so that the host's
              cost of each launch (argument checks, tensor maps, the ctypes
              call) does not fall between the events; the plain versions,
              thousands of small launches, are timed by events around each
              call.
 11. serve  — ``launch.serve.run`` on qwen3-4b and then rwkv6-7b at full
              width, 12 of 36 and 8 of 32 layers (cut for the script's
              time: the replay is an eager decode step a prompt token
              through every layer), random weights from a seed), batch
              4, prompt 512, 32 generated tokens, the memory freed
              between the two. Every counter is set to 0 before each
              run: the prefill must launch the arch's kernel once per
              layer and nothing else (qwen3-4b: every flash launch on the
              tensor-core kernel), the decode no kernel. qwen3-4b: the
              prefill's last-position logits must agree with the replay's
              last logits (kernel path against the plain decode path)
              within n_layers * 2^-8 of their largest magnitude (one bf16
              rounding per layer). Beside it, the plain prefill
              (use_kernel=False) against the same replay. rwkv6-7b, whose
              random weights magnify round-off with depth: the kernel's
              prefill at most twice as far from the replay as the plain
              prefill, and each layer's time-mix with the kernel against
              the plain recurrence on the served prefill's own
              activations. Then one more prefill and 8 decode steps under
              torch.profiler (CUDA activity) for the kernel's time in the
              prefill and the device's busy time (the profiler's host cost
              would inflate the served run's times).
 12. sagree — reduced serving in float32 on the card against the CPU, both
              archs: tokens equal, logits within 1e-4 of their largest
              magnitude.

The paper slice (no kernel of the port on its path: every launch counter
is set to 0 before each phase and must read 0 after it). All but phase 16
run in float64. The card side runs in this process; the port's CPU side
of phases 13-15 runs in four worker processes started together with it,
from the same inits (drawn on the CPU by a torch.Generator and copied).
Each phase prints its seconds and ms per iteration (host clock around
``run``, synchronized). Phases 13-15 run first, beside the kernel build
(they need no kernel of the port; the build's compilers share the host's
cores with them), phases 16 and 17 last, with the card to themselves:

 13. paper_fig2 — D-PPCA on §5.1's subspace data (500 x 20, M 5, noise
              0.2 I, 20 nodes), complete / ring / cluster x the six
              schemes, eta0 10, rel_tol 1e-3, min_iters 10, max 400: the
              card's iteration counts equal the CPU's, the max subspace
              angle to W_true within 1e-5 degrees, W within 1e-8 of max|W|.
 14. paper_fig3 — D-PPCA on turntable SfM (§5.2: 5 cameras, 30 frames, 90
              points), (ring, t_max 50), (complete, 50), (complete, 5) x
              the six schemes, against fit_svd of the pooled
              measurements; the same checks.
 15. paper_lsq — the quickstart's least squares in float64 (J 8, d 5, n
              20, inner 30, inner_lr 1.0, rel_tol 1e-8), complete and ring
              x the six schemes: iteration counts equal, max|w - w*| <
              1e-3; then the dynamic-topology example's three acts (J 12,
              expander, nap, budget scheduler with churn, node 7 dropped):
              masks and active edge fractions equal at every print, the
              survivors' spread under 1e-3.
     Then the inner solver at the quickstart's size, eager against the
              CUDA-graph replay that the engine uses on the card: equal
              bit for bit, both timed.
 16. scale_lsq — ConsensusADMM least squares in float32 at J 16 x A [8192,
              2048] (1.07 GB on the card), complete, nap, inner 30, 10
              iterations: max|w - w*| (w* from torch.linalg.lstsq of the
              stacked problem) and the consensus error each fall 10x from
              the init. One more iteration under torch.profiler: device
              busy ms, idle share, kernel launches.
 17. scale_sfm — D-PPCA, nap, complete, 50 iterations on turntable SfM at
              300 frames x 20,000 points (96 MB; the [J, J] probe
              broadcast about 0.5 GB): the structure angle to fit_svd
              falls below its init value and below SFM_ANGLE_BOUND_DEG;
              one more iteration under the profiler.

The async slice (after phase 8; the edge-gated round kernel on new inputs):

 18. async  — ``launch.train.run --async`` on qwen3-4b at full width, depth
              cut from 36 to 1 layer: 3 nodes on a ring, nap, the stale
              scheduler, max_staleness 1, node 0 4x slow on the modelled
              round clock, 1 local step, 12 steps, 4 x 512 tokens per
              node, lr 3e-4, under torch.profiler. Every round launches the
              gated kernel once and the ungated one never; node 0 advances
              on one tick in four; the per-round stale_edges and age_max
              and the executor's rounds_done equal those of the same
              launcher run on the CPU at reduced size. Prints the local and
              round seconds, the kernel's ms per round from the trace, the
              device's idle share, the peak memory and async_elapsed_s.
              The same run again, cut to 8 steps, without the profiler
              checks that node 0's parameter, lam and theta_bar_prev rows
              are bit-identical across every round it does not advance
              (host copies).
 18b. aagree — the reduced float32 async trainer on the card against the
              CPU (J=4, ring, node 0 2x slow, max_staleness 1) with the
              native and the fp8_e5m2 wire; and max_staleness 0 through the
              executor against the synchronous trainer on the card, bit for
              bit.
 18c. afull — in that second run, the first round whose kernel gets a
              non-zero staleness kick: the kernel's inputs are copied to
              the host before the launch, and theta', lam' and bar are held
              against the plain version in column chunks, bit for bit.

The observability slice (after phase 18b; the edge-gated round kernel,
with the obs rings appended in each round):

 19. obs dyn — ``launch.train.run`` on qwen3-4b at full width, 1 layer, 3
              nodes on a ring, nap, the budget scheduler, node 1 dropped
              after step 3, 1 local step, 8 steps, 4 x 512 tokens per
              node, lr 3e-4, four times in turns: obs off, obs on
              (``--obs-dir`` in a temporary directory, ring cap 4, drain
              every 4, ``--health``, ``--profile-rounds 2``), obs on
              without the profiler, obs off. Every round runs under
              ``torch.cuda.set_sync_debug_mode("warn")`` and its
              synchronising calls are counted: each obs-on round must make
              exactly as many as the obs-off round. On the profiled run:
              one gated launch per round; the drained rows' r_max and
              eta_mean equal the rounds' own bit for bit and the node
              ring's max r over live nodes equals r_max; node 1's drop is
              in events.jsonl; the Chrome trace holds every span, with the
              gated kernel launched inside consensus/fused_round; the
              port's validator and dashboard check pass; params, lam, eta
              and the mask equal the first obs-off run's bit for bit.
              Prints each run's step, local-step and round medians, the
              obs-on/obs-off ratio of the step medians (fails above
              1.10), the rings' bytes, each drain's ms and the kernel's
              ms in the profiled rounds.
 19b. obs async — the same with the async slice's arguments (phase 18)
              cut to 8 steps:
              the round clock's Perfetto trace present and valid, and the
              node ring's advance column showing node 0 on one tick in
              four.
 19c. obs agree — the reduced float32 trainer with obs on, card and CPU in
              lockstep from the same weights, both rings drained every 2
              rounds: dynamic (J=4, complete, budget with churn) and async
              (J=4, ring, node 0 2x slow) with the native wire, and async
              with the fp8_e5m2 wire with each CPU round started from the
              card's state. Step, age, liveness, advance and wire-byte
              columns equal; the rest within 1e-3; journal events equal.

The model zoo (after phase 12; every arch of the reference beyond qwen3-4b
and rwkv6-7b, random weights from seed 0, bf16; each phase prints its
seconds):

 20. zflash — the flash kernels at the zoo's shapes no earlier phase
              launches, as phase 9 holds and times them: hd 80
              (stablelm-3b: B 4, S 512, 32/32 heads) and hd 112 (kimi-k2:
              64 heads after the model's repeat), bf16 on the tensor-core
              kernel (at most 2.5x the library's time on the same inputs;
              the cc kernel timed beside, ungated) and f32 on the cc one,
              and the tensor-core kernel at hymba's 25 heads of 64 with a
              window of 1024 at S 2048. The build phase prints the
              registers and spills of both kernels' instantiations.
 21. zserve — ``launch.serve.run`` on glm4-9b (5 of 40 layers),
              qwen2-7b (4 of 28), stablelm-3b (4 of 32),
              moonshot-v1-16b-a3b (6 of 48),
              kimi-k2-1t-a32b (1 layer of 61: the whole model does not fit
              one card), musicgen-large (4 of 48) and
              llava-next-mistral-7b (4 of 32; the frontend stubs serve
              random embeddings; every cut but kimi-k2's is for time) at
              batch 4, prompt 512, and hymba-1.5b at 4 of its 32 layers
              (for time) and prompt 1280 (past its window of 1024, so the
              prefill's window binds and the decode's ring wraps), 8
              generated tokens, one after the other. Counters from
              0: the prefill launches the flash kernel once per layer, on
              the route ``kernels.flash_attention.route`` gives its head
              dim, which is the tensor-core kernel for every zoo arch
              (bf16 at hd 64, 80, 112 or 128), the decode none; every
              logit finite;
              layer 0's attention on the served prompt's activations
              through the kernel against the plain version (2e-2 of
              max(1, max|out|)). Prints prefill ms, decode ms per token,
              the kernel's device ms in the served prefill (CUDA events
              around each launch), the peak memory and
              ``Model.param_count`` beside the configs' reckoning.
 22. ztrain — ``launch.train.run`` at full width with depth cut
              (``ZOO_TRAIN_LAYERS``: glm4-9b, qwen2-7b and moonshot 1
              layer, llava 4, stablelm-3b and musicgen 8, hymba 2,
              rwkv6-7b 2): 2 nodes, ring, nap, eta0 0.1, native wire, lr
              3e-4, 4 x 512 tokens a node, 2 steps with a round after
              the second (the frontend stubs train on embeddings).
              Every round launches the ungated kernel once, no other
              kernel runs; its device time per round (CUDA events around
              the launch) is printed beside its byte bound, with the step
              seconds, wire bytes, losses and peak memory. kimi-k2 does
              not train on the card (about 450 GB of training state for
              its embedding and one layer).
 23. zagree — each zoo arch and rwkv6-7b, reduced, float32, on the card
              against the CPU from the same weights: served logits within
              1e-4 of their largest magnitude and tokens equal; one local
              step and one round: loss, r_max and eta to 1e-3, the duals
              to 5e-3 of their norm.

The ranks slice (the consensus trainer over torch.distributed, each rank
holding a block of the nodes; the ranks are ``chip_smoke.py --ranks-worker
SPEC`` processes under ``torchrun --standalone``, each returning digests
of its rows, computed on the card). Phases of one world size share a
torchrun call (``together``): each runs its one-process part, then the
ranks run every phase's part in turn over one process group, so that the
call's start and each rank's first warm step are paid once. Phases 24 and
27 (three ranks) run after phase 19c, then phase 25; phases 26, 29, 30a
and 31 (four ranks, 30a's part first) after phase 28:

 24. ranks  — ``launch.train.run`` on qwen3-4b at full width, 1 layer, 3
              nodes on a ring, nap, eta0 0.1, the budget scheduler, node 1
              dropped after step 2, 1 local step, 4 steps, 4 x 512 tokens
              a node, lr 3e-4: first as one process, then as three ranks
              of one node each sharing the card over gloo
              (``--dist-backend gloo``: rows staged through pinned host
              memory). Every node's parameter, lam and theta_bar_prev
              rows, eta, the mask and liveness after the last round, and
              every round's metrics, equal the one-process run's bit for
              bit; each rank launches the gated kernel once a round and
              the ungated one never. Prints each rank's peak memory, its
              kernel ms per round (CUDA events around the launch) beside
              the row's byte bound, the exchange's seconds per round
              (staging included), the wire bytes per node per offset, the
              step and round medians beside the one process's, and in how
              many rounds the ranks' kernels overlapped on the card.
 25. nccl1  — the static slice's arguments (2 nodes, 4 layers, the
              ungated round) as one rank over NCCL: the process group, the
              gathers and the exchange's local copies on the NCCL path;
              state and per-round metrics equal to phase 4's run bit for
              bit.
 26. sharded — the consensus state sharded in-pod
              (``--shard-consensus``): stablelm-3b at full width, 1
              layer (for the script's time), 2 nodes on a ring, nap,
              eta0 0.1, 4 x 512 tokens a node, lr 3e-4, 4 steps with a
              round every 2, on the native and then the fp8_e4m3 wire:
              first each as one process computing the 2-way sharded run
              whole (on ``trivial_grid(2, shards=2)``), then in the
              four-rank torchrun call as J 2 x S 2 gloo ranks sharing
              the card, rank r holding node r // 2 whole and slab r % 2 of
              its flat rows (lam and theta_bar_prev ``[1, total / 2]``).
              Every node's parameters, its lam and theta_bar_prev rows
              (the slabs' digests joined), eta, the mask and every round
              metric equal the one process's bit for bit; the two
              replicas of a node's parameters are equal after every step;
              each rank launches the round kernel on its slab once a round
              (ungated; per-block on fp8). Prints each rank's peak memory
              beside the peak reckoned from the code
              (``reckon_sharded_peak``), its slab kernel's ms beside the
              slab's byte bound, and the exchange's and the in-pod
              gathers' seconds a round. The pod's NCCL path (a card a
              rank) does not run on one card.
 26b. sharded async — a third run in phase 26's part: fp8_e4m3,
              ``--async``, ``max_staleness`` 1, node 0 4x slow, a round
              after each of 4 steps; each slab rank holds its slab of its
              node's wire ledger rows. Bit for bit against one process,
              the ledger slabs (joined) and w_prev included; every round
              launches the gated per-block kernel on each slab.
 27. pipe   — the round pipeline and the async executor across ranks:
              stablelm-3b at full width, 1 layer (for the script's
              time), 3 nodes on a ring (offsets 1, 2),
              nap, eta0 0.1, 4 x 512 tokens a node, lr
              3e-4; (a) synchronous static native rounds, 4 steps with a
              round every 2; (b) ``--async``, ``max_staleness`` 1, node 0
              4x slow, fp8_e4m3, a round after each of 6 steps. Each first
              as one process at ``pipeline_offsets`` 1, then both in the
              three-rank torchrun call as three gloo ranks sharing the
              card at
              ``pipeline_offsets`` 2 (two offsets' exchanges in flight
              ahead of the probes): every node's rows, eta, the mask, the
              ledger's rows and w_prev and every round metric equal bit
              for bit. Prints each rank's peak beside the reckoned one
              (``reckon_pipe_peak``), its pinned staging bytes, each
              round's exchange issue seconds, exposed wait (host time
              blocked in ``Pending.wait``) and probe seconds, and the
              kernel's ms beside the row's byte bound. NCCL's pipelined
              path across cards does not run on one card.
 28. ep     — expert-parallel serving through ``launch.steps.make_serve_fns``:
              moonshot-v1-16b-a3b at full width (d 2048, 16 heads of 128,
              64 experts, top 6, expert d_ff 1408, vocab 163,840, bf16),
              12 of 48 layers, on a data 1 x model 2 mesh (32 experts a
              model rank), capacity factor 1.25: (a) a prefill of 4 x 512
              tokens with ``use_kernel`` (the tensor-core flash kernel
              once a layer), each layer's dropped pairs printed; (b) 16
              decode steps from an empty state fed the prompt's first 16
              tokens. First as one process computing both model shards
              (``local_mesh``), then as two gloo ranks sharing the card
              under torchrun (all-to-all staged through pinned host
              buffers), each holding its shards only (since PR 29: its 32
              experts, 8 of the 16 heads and half the vocab, the
              attention tensor parallel). Checks: every
              prefill and decode logit of both ranks equals the one
              process's bit for bit, and so do the drop counts; layer 0's
              MoE at capacity factor 2.0 (nothing drops at ep 2) is within
              4 bf16 ulps of max|y| of ``moe_ref``; the decode logits at
              positions 0-15 match the prefill's within the serve bound
              (layers x 2^-8 of max|logit|) on every row none of whose
              first 16 tokens lost a pair; each rank launches the flash
              kernel once a layer (the one process once a layer for each
              model shard) and holds its shards' parameter bytes. Prints
              each rank's peak beside the
              reckoned parameter bytes and the one process's, prefill ms,
              decode ms a token and the all-to-all seconds (host clock,
              synchronized), and whether gloo takes CUDA tensors for
              all-to-all. NCCL's all-to-all (a card a rank) does not run
              on one card.
 29. inpod  — the in-pod sharded local step (``distributed.fsdp``):
              moonshot-v1-16b-a3b at full width, 1 of 48 layers (1.242 B
              parameters a node), bf16, capacity factor 1.25. (a)
              ``launch.steps.make_train_fns`` on a data 2 x model 2 mesh,
              global batch 4 x 512, 2 steps (lr 3e-4), each rank holding
              its shards of the parameters and AdamW moments (a quarter,
              but for the norms and the router); (b) the consensus trainer,
              J 2 ring, nap, native wire, ``shard_consensus``, data 1 x
              model 2 a node (4 ranks), 2 steps of 4 x 256 tokens a node
              with a round after the second (for the script's time).
              Each first as one process (``local_mesh``,
              ``trivial_grid(2, mesh=(1, 2))``), then as 4 gloo ranks
              sharing the card in the four-rank torchrun call (29a on
              ``init_mesh``, then 29b on ``init_ranks(mesh=)`` over the
              same process group). Checks: every rank's losses, grad
              norms, round metrics and eta, and the digests of its
              parameter and moment shards and its lam and theta_bar_prev
              slabs, equal the one process's bit for bit; so do the drops
              of each shard; a rank's parameter and moment bytes equal
              its shards' reckoned from the specs, between every two
              steps; each rank's round kernel launches once a round.
              Prints each rank's peak beside ``reckon_inpod_peak`` and
              the replicated layout (parameters and moments whole on
              every rank), the step and round seconds of runs with no stats
              (nothing synchronises inside a step), and from a separate
              run with the mesh's stats on (29a's two steps, 29b's first
              step), whose losses must equal the timed run's, the drops
              and the gathers', reduce-scatters' and all-to-alls' seconds
              a step (host clock, each between two synchronisations,
              staged gloo), and the kernel's ms beside its bound. NCCL
              across cards does not run on one card.
 30. replicated — the reference launcher's own command: stablelm-3b at
              full width (d 2560, 32 heads of 80, the tensor-core flash
              route), 1 of 32 layers (for the script's time), bf16, J 2
              ring, nap, native wire, 4 steps of 4 x 256 tokens a node
              with a round after every second, through
              ``launch.train.run``. (a) The consensus state replicated
              in-pod (no ``--shard-consensus``) on data 1 x model 2 a
              node: first as one process (``trivial_grid(2, mesh=(1,
              2))``), then as 4 gloo ranks sharing the card, each holding
              its shards of its node's parameters and moments and the
              node's whole flat rows; then the same ranks with
              ``--shard-consensus``, all in the four-rank torchrun call.
              Checks: every rank's round metrics,
              eta, mask, the digests of its shards and of its pod's whole
              lam and theta_bar_prev equal the one process's bit for bit,
              the two ranks of a pod hold the same row digests, and the
              sharded ranks equal their one-process run; the replicated
              and the sharded one-process runs agree, parameters, duals
              and means within 1e-5 and the residual metrics within 5e-4
              relative. (b) Checkpoint and resume through the launcher on
              the same ranks: the run to step 2 with ``--ckpt-dir`` and
              ``--ckpt-every 2`` in the same call, then a fresh
              torchrun that resumes to step 4; every rank's final digests
              equal the uninterrupted run's (a). The free disk space is
              checked first and the directory removed after. Prints each
              rank's state bytes beside the reckoning, its peak beside
              ``reckon_inpod_peak`` for whole rows, the step and round
              seconds and the kernel's ms on a whole row beside its byte
              bound; the bytes each rank wrote, the save and restore
              seconds and the host peak. NCCL across cards does not run
              on one card.

 31. tp     — tensor-parallel serving from sharded parameters
              (``launch.steps.make_serve_fns`` with ``decode_state_specs``):
              qwen3-4b at full width, 4 of 36 layers, then rwkv6-7b, 2 of
              32, bf16, on a data 2 x model 2 mesh; a prefill of 4 x 512
              tokens with ``use_kernel``, then 8 decode steps from an
              empty state fed the prompt's first 8 tokens. First as one
              process (``local_mesh(2, 2)``, every shard in turn), then as
              4 gloo ranks sharing the card in the four-rank torchrun call
              (after 30a, 26 and 29), each holding its shards of the
              parameters (FSDP over data; heads, d_ff and vocab over
              model) and of the decode state only. Checks: every prefill
              and decode logit of every rank equals the one process's bit
              for bit; the sharded prefill is within the serve bound
              (layers x 2^-8 of max|logit|) of the unsharded one; each
              rank launches the flash kernel (the scan) once a layer, on
              16 of 32 heads (32 of 64), and the decode none; a rank's
              parameter bytes equal ``fsdp.shard_bytes`` and its decode
              state's those of its shard shapes. Prints each rank's peak
              beside ``reckon_tp_peak`` and the whole-parameter layout's,
              prefill ms and decode ms a token (no stats), and from the
              stats-on pass the seconds of the model sums and the data
              gathers (host clock, staged gloo). NCCL across cards does
              not run on one card.

The second-to-last line holds every kernel's numbers as JSON; the last line
is the run's verdict.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# NVIDIA H100 SXM data sheet: HBM3 rate, f32 outside the tensor cores, the
# dense bf16 and TF32 tensor-core rates (the sheet's 1,979 and 989 TFLOP/s
# are with sparsity)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12
TF32_FLOPS_PER_S = 494.5e12
# f32 products on the tensor cores keep about f32's precision in three TF32
# products a term (csrc/mma_tf32.cuh): the least time for f32 attention
F32_TF32_PARTS = 3
# the tensor-core flash kernel's gate: at most this many times the
# library's scaled_dot_product_attention on the same inputs (phases 9, 20)
TC_LIBRARY_RATIO = 2.5

DEV = "cuda"
KERNEL_NAME = "consensus_round_kernel"      # the CUDA kernels, in a trace
MASKED_NAME = "consensus_round_masked_kernel"
FLASH_NAME = "flash_attention_kernel"      # the cc kernel (mma.sync)
FLASH_TC_NAME = "flash_attention_tc_kernel"
SCAN_NAME = "rwkv6_scan_kernel"
SCAN_PATH = SCAN_NAME + "<bf16,64,32>"     # the instantiation rwkv6-7b runs
SLICE_ARGS = ["--nodes", "2", "--scheme", "nap", "--topology", "ring",
              "--local-steps", "2", "--steps", "8", "--batch-per-node", "4",
              "--seq", "512", "--lr", "3e-4", "--device", DEV]
SLICE_LAYERS = 4
DYN_ARGS = ["--nodes", "3", "--scheme", "nap", "--topology", "ring",
            "--topo-scheduler", "budget", "--drop-node", "3:1",
            "--local-steps", "2", "--steps", "8", "--batch-per-node", "4",
            "--seq", "512", "--lr", "3e-4", "--device", DEV]
DYN_LAYERS = 1
ASYNC_ARGS = ["--nodes", "3", "--scheme", "nap", "--topology", "ring",
              "--async", "--max-staleness", "1", "--slow-node", "0:4.0",
              "--local-steps", "1", "--steps", "12", "--batch-per-node", "4",
              "--seq", "512", "--lr", "3e-4", "--device", DEV]
ASYNC_LAYERS = 1
OBS_LAYERS = 1
OBS_DYN_ARGS = ["--nodes", "3", "--scheme", "nap", "--topology", "ring",
                "--topo-scheduler", "budget", "--drop-node", "3:1",
                "--local-steps", "1", "--steps", "8", "--batch-per-node",
                "4", "--seq", "512", "--lr", "3e-4", "--device", DEV]
# phase 18's checked run and 19b: the async path's arguments cut to 8
# steps for the script's time
OBS_ASYNC_ARGS = ASYNC_ARGS[:ASYNC_ARGS.index("--steps") + 1] + ["8"] + \
    ASYNC_ARGS[ASYNC_ARGS.index("--steps") + 2:]
ASYNC_CHECK_ARGS = OBS_ASYNC_ARGS
SERVE_ARGS = ["--batch", "4", "--prompt-len", "512", "--gen-len", "32",
              "--device", DEV]
# phase 11's depths, cut for the script's time: the prompt's replay is 512
# eager decode steps through every layer (at full depth, 36 and 32 layers,
# each arch's phase took 42-43 s on an H100, most of it the replay)
SERVE_LAYERS = {"qwen3-4b": 12, "rwkv6-7b": 8}
# the model zoo (phases 20-23): the archs beyond qwen3-4b and rwkv6-7b
ZOO = ("glm4-9b", "qwen2-7b", "stablelm-3b", "moonshot-v1-16b-a3b",
       "kimi-k2-1t-a32b", "musicgen-large", "hymba-1.5b",
       "llava-next-mistral-7b")
# phase 21: (layers, prompt length); None keeps the full depth. kimi-k2's
# 61 layers (1.03 T parameters) do not fit one card: its embedding, one
# layer and its head are 19.4 B parameters, 38.8 GB in bf16. hymba's window
# of 1024 binds only past 1024 tokens: at 1280 the prefill's window binds
# and the decode's ring wraps by 256 positions (its replay, a step of eager
# launches per token, takes 1.6x as long at 2048; phase 20 runs the kernel
# at 2048)
ZOO_SERVE = {arch: (None, 512) for arch in ZOO}
ZOO_SERVE["kimi-k2-1t-a32b"] = (1, 512)
# hymba is cut to 8 of its 32 layers for time (its eager SSM loop and
# prompt replay took 105-308 s at full depth), to pay for phase 26, and
# to 4 for phase 30
ZOO_SERVE["hymba-1.5b"] = (4, 1280)
# cut for time, to pay for phases 28 to 30: each prompt replay is 512
# eager decode steps through every layer (at full depth moonshot's took
# about 44 s, musicgen's 21-63 s, llava's 24-40 s, glm4's 22-39 s); each
# at half its depth or less for phase 28, half that again for phase 29,
# and half that again for phase 30
ZOO_SERVE["moonshot-v1-16b-a3b"] = (6, 512)
ZOO_SERVE["musicgen-large"] = (4, 512)
ZOO_SERVE["llava-next-mistral-7b"] = (4, 512)
ZOO_SERVE["glm4-9b"] = (5, 512)
ZOO_SERVE["qwen2-7b"] = (4, 512)
ZOO_SERVE["stablelm-3b"] = (4, 512)
ZOO_GEN = 8                         # generated tokens per served arch
# billions of parameters at those depths, reckoned from the configs
# before the port counted them (printed beside Model.param_count; the
# depths cut for phases 29 and 30 from the defs' shapes at the cut depth)
ZOO_PARAMS_B = {"glm4-9b": 2.26, "qwen2-7b": 2.02,  # 5, 4 layers
                "stablelm-3b": 0.57,                         # 4 layers
                "moonshot-v1-16b-a3b": 4.09,                 # 6 layers
                "kimi-k2-1t-a32b": 19.38,
                "musicgen-large": 0.28, "hymba-1.5b": 0.26,  # 4, 4 layers
                "llava-next-mistral-7b": 1.13}               # 4 layers
# phase 22: layers at full width, so that two replicas with f32 AdamW
# moments and the f32 dual and neighbour-mean rows fit in 80 GB (about 23
# bytes per parameter per node with the activations, as the static
# training slice measured).
# kimi-k2 does not train on the card: its embedding and one layer are
# 19.4 B parameters a node, about 450 GB of training state. hymba is cut to
# 4 layers for time, not memory (2 since phase 30): its SSM loop is an
# eager step per token in every layer, so a local step's time grows with
# the depth.
ZOO_TRAIN_LAYERS = {"glm4-9b": 1, "qwen2-7b": 1, "moonshot-v1-16b-a3b": 1,
                    "llava-next-mistral-7b": 4, "stablelm-3b": 8,
                    "rwkv6-7b": 2, "musicgen-large": 8, "hymba-1.5b": 2}
ZOO_TRAIN_ARGS = ["--nodes", "2", "--scheme", "nap", "--topology", "ring",
                  "--eta0", "0.1", "--wire-codec", "native",
                  "--local-steps", "2", "--steps", "2", "--batch-per-node",
                  "4", "--seq", "512", "--lr", "3e-4", "--device", DEV]
SOURCES = ("consensus_round", "consensus_update", "flash_attention",
           "flash_attention_tc", "rwkv6_scan")
# the round wrapper's launch counters
COUNTS = ("launches", "masked_launches", "per_block_launches")


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def nbytes(t) -> int:
    return t.numel() * t.element_size()


def round_bound(theta, lam, bar_prev, wires, scales, e_sym, block_leaf,
                gates=None):
    """(bound_ms, bound_by, bytes, ops) of one fused round on these inputs:
    each input read once, each output written once (theta', lam', bar and
    the [J] residuals); about 17 + 4 deg f32 operations per element, and
    with ``gates`` (the gated round's keywords) 2 deg more for the gated
    mean and, with a kick, 2 deg + 3 more."""
    j, total = theta.shape
    deg = wires.shape[0]
    gates = gates or {}
    read = sum(nbytes(t) for t in (theta, lam, bar_prev, wires, scales,
                                   e_sym, block_leaf, *gates.values())) \
        + 3 * 4 * j
    written = nbytes(theta) + nbytes(lam) + 4 * j * total + 2 * 4 * j
    per_elem = 17 + 4 * deg
    if gates:
        per_elem += 2 * deg
    if "kick_w" in gates:
        per_elem += 2 * deg + 3
    ops = j * total * per_elem
    t_bytes = (read + written) / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), read + written, ops


def time_cuda(fn, reps: int, warmup: int = 2) -> float:
    """Median milliseconds of ``fn`` over ``reps`` runs, CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def print_clocks(when: str) -> None:
    """The card's SM clock, its maximum and its temperature (times on one
    card model differ between cards and runs; these say by how much the
    card was held back)."""
    query = "clocks.sm,clocks.max.sm,temperature.gpu,power.draw"
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"clocks at {when}: sm, max sm, temperature, power: {out}",
          flush=True)


def time_device(fn, reps: int, warmup: int = 3) -> float:
    """Device milliseconds per call of ``fn`` over ``reps`` calls launched
    back to back behind a device-side sleep (CUDA events around the calls):
    the host enqueues all of them while the card sleeps, so its own cost
    per launch does not count, as inside a model's forward where the host
    runs ahead of the card."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2e6) * reps)     # about 1 ms of sleep per call
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def device_profile(prof, top_n: int = 8, kernel: str = KERNEL_NAME):
    """From a CUDA-activity profile: the launch times in order (ms) of the
    fused kernel named ``kernel``, the device's busy ms (the union of every
    kernel, copy and set on the card), device ms by kernel family, and the
    ``top_n`` kernel names by device time with their counts."""
    from torch.autograd import DeviceType
    spans, per_name, fused = [], {}, []
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        t0, t1 = ev.time_range.start, ev.time_range.end        # us
        spans.append((t0, t1))
        n, ms = per_name.get(ev.name, (0, 0.0))
        per_name[ev.name] = (n + 1, ms + (t1 - t0) / 1e3)
        if kernel in ev.name:
            fused.append((t0, (t1 - t0) / 1e3))
    busy, end = 0.0, float("-inf")
    for t0, t1 in sorted(spans):
        if t1 > end:
            busy += t1 - max(t0, end)
            end = t1
    families = {"consensus_round": 0.0, "flash_attention": 0.0,
                "rwkv6_scan": 0.0, "gemm": 0.0, "copy/set": 0.0,
                "other": 0.0}
    for name, (_, ms) in per_name.items():
        low = name.lower()
        fam = ("consensus_round" if (KERNEL_NAME in name
                                     or MASKED_NAME in name)
               else "flash_attention" if (FLASH_NAME in name
                                          or FLASH_TC_NAME in name)
               else "rwkv6_scan" if SCAN_NAME in name
               else "copy/set" if low.startswith(("memcpy", "memset"))
               else "gemm" if any(k in low for k in ("gemm", "xmma", "nvjet",
                                                     "cutlass", "sm90_"))
               else "other")
        families[fam] += ms
    top = sorted(per_name.items(), key=lambda kv: -kv[1][1])[:top_n]
    return [ms for _, ms in sorted(fused)], busy / 1e3, families, top


def traced_ok(in_round, launches: int) -> bool:
    """Whether a profiler trace agrees with a kernel's launch count. The
    count (the wrapper's) is exact; the trace is not: on the card its
    device-event total varied by up to 3 between identical runs in one
    process (17,921 to 17,924), so it may lose a kernel's record. It must
    hold at least one launch, and never more than were counted; a loss is
    printed."""
    if len(in_round) < launches:
        print(f"  the profiler lost {launches - len(in_round)} of "
              f"{launches} kernel records", flush=True)
    return 1 <= len(in_round) <= launches


def bf16_ulp_ok(a, b) -> bool:
    """Every element of bf16 ``a`` within one bf16 ulp of ``b``."""
    import torch
    af, bf = a.float(), b.float()
    _, e = torch.frexp(bf)
    ulp = torch.ldexp(torch.ones_like(bf), e - 8)   # 8 significand bits
    return bool(((af - bf).abs() <= ulp).all())


def compare(name, k_out, r_out, theta_dtype):
    """Hold kernel outputs against the plain version's; returns max abs err
    over theta', lam' and bar."""
    import torch
    tn_k, ln_k, bar_k, rsq_k, ssq_k = k_out
    tn_r, ln_r, bar_r, rsq_r, ssq_r = r_out
    if theta_dtype == torch.bfloat16:
        check(bf16_ulp_ok(tn_k, tn_r), f"{name}: theta' beyond one bf16 ulp")
    else:
        check(torch.allclose(tn_k, tn_r, rtol=1e-5, atol=1e-6),
              f"{name}: theta' mismatch")
    # lam' and bar: float32 round-off (FMA contraction would be ~1 ulp)
    check(torch.allclose(ln_k, ln_r, rtol=1e-5, atol=1e-6),
          f"{name}: lam' mismatch")
    check(torch.allclose(bar_k, bar_r, rtol=1e-5, atol=1e-6),
          f"{name}: bar mismatch")
    # r^2, s^2: summation order inside a block differs
    check(torch.allclose(rsq_k, rsq_r, rtol=1e-4, atol=0),
          f"{name}: r_sq {rsq_k.tolist()} vs {rsq_r.tolist()}")
    check(torch.allclose(ssq_k, ssq_r, rtol=1e-4, atol=0),
          f"{name}: s_sq {ssq_k.tolist()} vs {ssq_r.tolist()}")
    return max(float((x.float() - y.float()).abs().max())
               for x, y in ((tn_k, tn_r), (ln_k, ln_r), (bar_k, bar_r)))


def make_round_inputs(layout, j, offsets, theta_dtype, codec_name, seed):
    """A round's inputs on the card for ``layout``: node params ~N(0, 0.02)
    in the packed layout (zero padding), duals and last means nearby, the
    wire encoded by the codec and rolled once per offset (copies)."""
    import torch
    from repro_torch import wire as wire_lib
    dev = torch.device(DEV)
    g = torch.Generator(device=dev).manual_seed(seed)
    total = layout.total
    mask = torch.zeros(total, dtype=torch.bool, device=dev)
    for lf in layout.leaves:
        mask[lf.offset:lf.offset + lf.size] = True
    theta = torch.randn(j, total, generator=g, device=dev).mul_(0.02) \
        .mul_(mask).to(theta_dtype)
    lam = torch.randn(j, total, generator=g, device=dev).mul_(1e-3) \
        .mul_(mask)
    bar_prev = torch.randn(j, total, generator=g, device=dev).mul_(1e-3) \
        .add_(theta.float()).mul_(mask)
    codec = wire_lib.get_codec(codec_name, layout)
    wire = codec.encode(theta)
    rolled = torch.stack([torch.roll(wire, -off, 0) for off in offsets])
    del wire
    payload, scales = codec.decode(rolled)
    wires = payload.contiguous()
    del rolled, payload
    deg = len(offsets)
    if scales is None:
        scales = torch.ones(deg, j, layout.num_leaves, device=dev)
    e_sym = 0.05 + 0.2 * torch.rand(deg, j, generator=g, device=dev)
    eta_sum = e_sym.sum(0)
    alpha = 0.5 / (1.0 + 2.0 * eta_sum)
    eta_node = eta_sum / deg
    block_leaf = torch.as_tensor(layout.block_leaf, dtype=torch.int32,
                                 device=dev)
    return (theta, lam, bar_prev, wires, scales.contiguous(), e_sym, alpha,
            eta_sum, eta_node, block_leaf)


def kernel_case(name, layout, j, offsets, theta_dtype, codec_name, seed):
    """Phase 3: one shape, kernel vs plain version, both timed."""
    import torch
    from repro_torch.kernels import ops, ref
    args = make_round_inputs(layout, j, offsets, theta_dtype, codec_name,
                             seed)
    theta, lam, bar_prev, wires, scales, e_sym, alpha, eta_sum, eta_node, \
        block_leaf = args
    kw = dict(block_leaf=block_leaf, block_size=layout.block_size)
    rest = (wires, scales, e_sym, alpha, eta_sum, eta_node)
    r_out = ref.consensus_round_ref(theta, lam, bar_prev, *rest, **kw)
    k_out = ops.consensus_round(theta.clone(), lam.clone(), bar_prev.clone(),
                                *rest, **kw)
    torch.cuda.synchronize()
    err = compare(name, k_out, r_out, theta_dtype)
    del k_out, r_out
    tk, lk, bk = theta.clone(), lam.clone(), bar_prev.clone()
    k_ms = time_cuda(lambda: ops.consensus_round(tk, lk, bk, *rest, **kw),
                     reps=20)
    del tk, lk, bk
    p_ms = time_cuda(lambda: ref.consensus_round_ref(theta, lam, bar_prev,
                                                     *rest, **kw), reps=10)
    bound_ms, by, nb, _ = round_bound(theta, lam, bar_prev, wires, scales,
                                      e_sym, block_leaf)
    print(f"kernel {name}: J={j} deg={len(offsets)} total={layout.total} "
          f"max_abs_err={err:.3g} kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, "
          f"bound {bound_ms:.3f} ms ({by}, {nb / 1e9:.3f} GB)", flush=True)


def full_shape_check(layout, j, offsets, gated=False, seed=5,
                     codec_name="native"):
    """Phases 5, 8 and (b): the kernel (ungated, or gated with kicks) at a
    slice's own shape, and the plain version over block-aligned column
    chunks of the same inputs. The gated kernel, and the kernel with an
    fp8 wire's per-block scales, must equal the plain version bit for
    bit."""
    import torch
    from repro_torch.kernels import ops, ref
    args = make_round_inputs(layout, j, offsets, torch.bfloat16, codec_name,
                             seed=seed)
    gates = {}
    if gated:
        args, gates = gate_round_inputs(args, kick=True, seed=seed)
    theta, lam, bar_prev, wires, scales, e_sym, alpha, eta_sum, eta_node, \
        block_leaf = args
    bound_ms, by, nb, _ = round_bound(theta, lam, bar_prev, wires, scales,
                                      e_sym, block_leaf, gates)
    per_block = per_block_of(codec_name, layout)
    exact = gated or per_block
    rest = (e_sym, alpha, eta_sum, eta_node)
    kw = dict(block_leaf=block_leaf, block_size=layout.block_size,
              scales_per_block=per_block, **gates)
    tk, lk, bk = theta.clone(), lam.clone(), bar_prev.clone()
    k_out = ops.consensus_round(tk, lk, bk, wires, scales, *rest, **kw)
    torch.cuda.synchronize()

    bs = layout.block_size
    chunk = 1024 * bs
    rsq = torch.zeros(j, device=DEV)
    ssq = torch.zeros(j, device=DEV)
    err = 0.0
    t_plain = 0.0
    for c0 in range(0, layout.total, chunk):
        c1 = min(c0 + chunk, layout.total)
        sl = slice(c0, c1)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        cols = slice(c0 // bs, c1 // bs)
        out = ref.consensus_round_ref(
            theta[:, sl], lam[:, sl], bar_prev[:, sl], wires[:, :, sl],
            scales[..., cols] if per_block else scales, *rest,
            block_leaf=block_leaf[cols], block_size=bs,
            scales_per_block=per_block, **gates)
        b.record()
        torch.cuda.synchronize()
        t_plain += a.elapsed_time(b)
        tn_r, ln_r, bar_r, r_c, s_c = out
        if exact:
            for x, y, what in zip(k_out[:3], out[:3], ("theta'", "lam'",
                                                       "bar")):
                check(torch.equal(x[:, sl], y), f"full {codec_name}: {what}"
                      " differs from the plain version")
        else:
            check(bf16_ulp_ok(k_out[0][:, sl], tn_r),
                  "full: theta' beyond ulp")
            check(torch.allclose(k_out[1][:, sl], ln_r, rtol=1e-5,
                                 atol=1e-6), "full: lam' mismatch")
            check(torch.allclose(k_out[2][:, sl], bar_r, rtol=1e-5,
                                 atol=1e-6), "full: bar mismatch")
        err = max(err, *(float((x[:, sl].float() - y.float()).abs().max())
                         for x, y in zip(k_out[:3], out[:3])))
        rsq += r_c
        ssq += s_c
        del out
    check(torch.allclose(k_out[3], rsq, rtol=1e-4), "full: r_sq mismatch")
    check(torch.allclose(k_out[4], ssq, rtol=1e-4), "full: s_sq mismatch")
    rel = rs_rel_err(k_out[3:], (rsq, ssq))
    k_ms = time_cuda(lambda: ops.consensus_round(tk, lk, bk, wires, scales,
                                                 *rest, **kw), reps=10)
    print(f"kernel full shape {codec_name}{' gated+kick' if gated else ''}: "
          f"J={j} "
          f"deg={len(offsets)} total={layout.total} max_abs_err={err:.3g} "
          f"r2/s2 rel {rel:.3g} kernel {k_ms:.3f} ms, plain (chunked) "
          f"{t_plain:.3f} ms, bound {bound_ms:.3f} ms ({by}, "
          f"{nb / 1e9:.3f} GB)", flush=True)
    del args, theta, lam, bar_prev, wires, scales, tk, lk, bk, k_out
    torch.cuda.empty_cache()
    return dict(max_abs_err=err, ms=k_ms, plain_ms=t_plain,
                bound_ms=bound_ms, bound_by=by)


def rs_rel_err(k_rs, r_rs) -> float:
    """Largest relative difference of r^2 and s^2 (where the plain version
    is non-zero; a zero must be matched by a zero)."""
    worst = 0.0
    for x, y in zip(k_rs, r_rs):
        nz = y != 0
        check(bool((x[~nz] == 0).all()), "a zero residual came out non-zero")
        if bool(nz.any()):
            worst = max(worst, float(((x[nz] - y[nz]).abs()
                                      / y[nz].abs()).max()))
    return worst


def gate_round_inputs(args, kick: bool, seed: int):
    """Turn ``make_round_inputs``' ungated round into a gated one, as the
    dynamic trainer builds it: gates mixed 0/1 with node J-1 a ghost
    (inv_deg 0), offset 0 dead for every node (zero payload, unit scales),
    gated edges' weights zeroed in e_sym, and with ``kick`` non-zero
    zero-kick weights on the gated edges of live offsets. Returns (args,
    gate keywords)."""
    import torch
    theta, lam, bar_prev, wires, scales, e_sym, alpha, eta_sum, eta_node, \
        block_leaf = args
    deg, j = e_sym.shape
    g = torch.Generator(device=DEV).manual_seed(seed)
    bar_w = torch.randint(0, 2, (deg, j), generator=g, device=DEV).float()
    bar_w[:, j - 1] = 0.0                          # ghost row
    bar_w[0, :] = 0.0                              # dead offset
    if deg > 1:
        bar_w[1, 0] = 1.0                          # a live edge
        bar_w[deg - 1, 1] = 0.0                    # a gated edge
    wires[0].zero_()
    scales[0] = 1.0
    e_sym = (e_sym * bar_w).contiguous()
    act = bar_w.sum(0)
    inv_deg = torch.where(act > 0, 1.0 / act.clamp_min(1.0), 0.0)
    eta_sum = e_sym.sum(0)
    alpha = 0.5 / (1.0 + 2.0 * eta_sum)
    eta_node = eta_sum * inv_deg
    gates = dict(bar_w=bar_w, inv_deg=inv_deg)
    if kick:
        kw = (0.05 + 0.2 * torch.rand(deg, j, generator=g, device=DEV)) \
            * (1.0 - bar_w)
        kw[0] = 0.0
        kw[:, j - 1] = 0.0
        check(bool((kw > 0).any()), "no gated edge carries a kick")
        gates["kick_w"] = kw.contiguous()
    return (theta, lam, bar_prev, wires, scales, e_sym, alpha, eta_sum,
            eta_node, block_leaf), gates


def per_block_of(codec_name, layout) -> bool:
    """Whether the codec's wire carries per-block scales (the fp8 ones)."""
    from repro_torch import wire as wire_lib
    return wire_lib.get_codec(codec_name, layout).kernel_dequant_spec(
    ).per_block


def exact_case(name, layout, j, offsets, theta_dtype, codec_name, variant,
               seed):
    """Phases 6 and (a): the round kernel at one shape against its plain
    version (theta', lam' and bar bit for bit), both timed and printed.
    ``variant``: ``ungated``, ``gated`` (gates with a ghost row and a dead
    offset) or ``kick`` (gated, with non-zero kicks on gated edges)."""
    import torch
    from repro_torch.kernels import ops, ref
    args = make_round_inputs(layout, j, offsets, theta_dtype, codec_name,
                             seed)
    gates = {}
    if variant != "ungated":
        args, gates = gate_round_inputs(args, variant == "kick", seed)
    theta, lam, bar_prev, wires, scales, e_sym, alpha, eta_sum, eta_node, \
        block_leaf = args
    kw = dict(block_leaf=block_leaf, block_size=layout.block_size,
              scales_per_block=per_block_of(codec_name, layout), **gates)
    rest = (wires, scales, e_sym, alpha, eta_sum, eta_node)
    r_out = ref.consensus_round_ref(theta, lam, bar_prev, *rest, **kw)
    k_out = ops.consensus_round(theta.clone(), lam.clone(), bar_prev.clone(),
                                *rest, **kw)
    torch.cuda.synchronize()
    for x, y, what in zip(k_out[:3], r_out[:3], ("theta'", "lam'", "bar")):
        check(torch.equal(x, y), f"{name}: {what} differs from the plain "
              f"version (max {float((x.float() - y.float()).abs().max()):.3g})")
    rel = rs_rel_err(k_out[3:], r_out[3:])
    check(rel < 1e-6, f"{name}: r^2/s^2 relative error {rel:.3g}")
    del k_out, r_out
    tk, lk, bk = theta.clone(), lam.clone(), bar_prev.clone()
    k_ms = time_cuda(lambda: ops.consensus_round(tk, lk, bk, *rest, **kw),
                     reps=20)
    del tk, lk, bk
    p_ms = time_cuda(lambda: ref.consensus_round_ref(theta, lam, bar_prev,
                                                     *rest, **kw), reps=5)
    bound_ms, by, nb, _ = round_bound(theta, lam, bar_prev, wires, scales,
                                      e_sym, block_leaf, gates)
    print(f"exact kernel {name}: J={j} deg={len(offsets)} "
          f"total={layout.total} max_abs_err=0 r2/s2 rel {rel:.3g} kernel "
          f"{k_ms:.3f} ms, plain {p_ms:.3f} ms, bound {bound_ms:.3f} ms "
          f"({by}, {nb / 1e9:.3f} GB)", flush=True)
    return dict(ms=k_ms, plain_ms=p_ms, bound_ms=bound_ms, bound_by=by,
                max_abs_err=0.0)


def dynamic_slice(full, card_line):
    """Phase 7: the dynamic-topology path at full width, one layer, under
    torch.profiler; returns the gated kernel's launches and in-round
    times."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_lib
    from repro_torch.models import build_model
    cfg = dataclasses.replace(full, n_layers=DYN_LAYERS)
    args = train_lib.parse_args(DYN_ARGS)
    torch.cuda.reset_peak_memory_stats()
    for c in COUNTS:
        setattr(ops.consensus_round, c, 0)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA],
            acc_events=True) as prof:
        t0 = time.perf_counter()
        record = train_lib.run(cfg, args)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    ungated, masked, per_block = (getattr(ops.consensus_round, c)
                                  for c in COUNTS)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    in_round, busy_ms, families, top = device_profile(prof,
                                                      kernel=MASKED_NAME)
    ungated_traced = device_profile(prof)[0]
    del prof
    losses, rounds = record["losses"], record["rounds"]
    n_rounds = args.steps // args.local_steps
    check(record["offsets"] == [1, 2], f"offsets {record['offsets']}")
    check(len(losses) == args.steps and all(map(math.isfinite, losses)),
          f"losses {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    check(len(rounds) == n_rounds, f"{len(rounds)} rounds, want {n_rounds}")
    for r in rounds:
        check(math.isfinite(r["r_max"]) and math.isfinite(r["eta_mean"]),
              f"round metrics {r}")
        check(r["masked_launches"] == 1 and r["launches"] == 0,
              f"a round launched {r['masked_launches']} gated and "
              f"{r['launches']} ungated kernels")
    check(any(abs(r["eta_mean"] - args.eta0) > 1e-6 for r in rounds),
          "nap never moved eta off eta0")
    # rounds at steps 1, 3 | node 1 dropped after step 3 | rounds at 5, 7
    for r in rounds[:2]:
        check(r["alive"] == [True] * 3 and abs(r["active_edges"] - 1) < 1e-6,
              f"before the drop: {r}")
    for r in rounds[2:]:
        check(r["alive"] == [True, False, True]
              and abs(r["active_edges"] - 2 / 6) < 1e-6,
              f"after the drop: {r}")
    check(ungated == 0 and masked == n_rounds and per_block == 0,
          f"launches: {masked} gated, {ungated} ungated, {per_block} "
          f"per-block in {n_rounds} rounds")
    check(traced_ok(in_round, n_rounds) and not ungated_traced,
          f"the trace holds {len(in_round)} {MASKED_NAME} and "
          f"{len(ungated_traced)} {KERNEL_NAME} launches")
    layout = record["layout"]
    j, deg = 3, 2
    bound = j * layout.total * (2 + 2 + 4 + 4 + 4 + 4 + 2 * deg) \
        / HBM_BYTES_PER_S * 1e3
    print(f"dyn slice: {cfg.arch_id} x{DYN_LAYERS} layer at full width, "
          f"{build_model(cfg).param_count()} parameters per node, "
          f"{layout.total} elements per node row, {len(rounds)} rounds, "
          f"gated launches {masked}, ungated {ungated}", flush=True)
    print("dyn step seconds: "
          + " ".join(f"{t:.3f}" for t in record["step_seconds"])
          + f" [{card_line}]", flush=True)
    print("dyn losses: " + " ".join(f"{x:.4f}" for x in losses))
    print("dyn rounds: " + json.dumps(rounds), flush=True)
    print(f"dyn kernel in rounds: median {np.median(in_round):.3f} ms "
          f"(each {', '.join(f'{t:.3f}' for t in in_round)}), bound "
          f"{bound:.3f} ms; peak memory {peak_gb:.2f} GB [{card_line}]",
          flush=True)
    print(f"dyn trace: host {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms, "
          f"idle share {1 - busy_ms / wall_ms:.4f}; device ms by family: "
          + ", ".join(f"{k} {v:.1f}" for k, v in families.items()),
          flush=True)
    for name, (n, ms) in top:
        print(f"  {ms:10.1f} ms {n:6d}x  {name[:110]}")
    return dict(launches=masked, in_round_ms=float(np.median(in_round)),
                layout=layout)


def agree_dynamic_with_cpu(steps: int = 6, codec: str = "native",
                           rtol: float = 1e-3) -> None:
    """Phases 7b and (d): the reduced float32 trainer on a dynamic topology
    (J=4, complete, round_robin with churn, node 1 dropped after step 3)
    with the ``codec`` wire: losses, r_max, eta and the active edge
    fraction on the card equal the CPU's to ``rtol``, masks and liveness
    exactly, and non-zero kicks reached the card's kernel. Each round, the
    card's wire of the card's parameters equals, byte for byte, the CPU's
    encode of the same parameters."""
    import torch
    from repro_torch.configs import get_reduced_config
    from repro_torch.core.penalty import PenaltyConfig
    from repro_torch.data import DataConfig, SyntheticTokens
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.optim import ConsensusConfig, ConsensusTrainer
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.topology import TopologyConfig
    cfg = dataclasses.replace(get_reduced_config("qwen3-4b"),
                              dtype="float32")
    model = build_model(cfg)
    params1 = model.init(torch.Generator().manual_seed(0), "cpu")
    traces, masks, kicked = {}, {}, {}
    for dev in (DEV, "cpu"):
        tr = ConsensusTrainer(
            model, num_nodes=4, device=dev, adamw=AdamWConfig(lr=1e-2),
            consensus=ConsensusConfig(
                penalty=PenaltyConfig(scheme="nap", eta0=0.1),
                topology="complete", local_steps=1, wire_codec=codec,
                dyn_topology=TopologyConfig(scheduler="round_robin",
                                            churn=True)))
        data = SyntheticTokens(DataConfig(vocab=cfg.vocab, seq_len=32,
                                          batch_per_node=4, num_nodes=4),
                               device=dev)
        state = tr.init_state(params1)
        before = ops.consensus_round.masked_launches
        trace, mk, kicks = [], [], 0
        for step in range(steps):
            state, m = tr.train_step(state, data.batch(step))
            if dev == DEV:
                buf = tr.layout.pack(state.params, dtype=tr.layout.wire_dtype)
                check(torch.equal(tr.codec.encode(buf).cpu(),
                                  tr.codec.encode(buf.cpu())),
                      f"{codec}: the card's wire bytes differ from the CPU's")
                del buf
            kicks += int(bool((state.topo.kick != 0).any()))
            state, cm = tr.consensus_step(state, data.batch(10**6 + step))
            trace += [float(m["loss"]), float(cm["r_max"]),
                      float(cm["eta_mean"]), float(cm["active_edges"])]
            if step == 3:
                state = tr.apply_churn(state, 1)
            mk.append(state.topo.mask.cpu().numpy())
        if dev == DEV:
            check(ops.consensus_round.masked_launches - before == steps,
                  "the card's dynamic rounds did not all launch the gated "
                  "kernel")
        traces[dev], masks[dev], kicked[dev] = np.asarray(trace), mk, kicks
    card, cpu = traces[DEV], traces["cpu"]
    rel = float(np.max(np.abs(card - cpu) / np.maximum(np.abs(cpu), 1e-12)))
    check(bool(np.all(np.isfinite(card))) and rel < rtol,
          f"dynamic {codec} card vs cpu trace: {card.tolist()} vs "
          f"{cpu.tolist()}")
    check(all(np.array_equal(a, b) for a, b in zip(masks[DEV],
                                                    masks["cpu"])),
          "dynamic card vs cpu: masks differ")
    check(kicked[DEV] > 0, "no round carried a non-zero kick")
    print(f"dagree: reduced float32 dynamic trainer, {codec} wire, {steps} "
          f"rounds, {kicked[DEV]} with non-zero kicks, card vs cpu max "
          f"relative difference {rel:.3g}, masks equal, wire bytes equal",
          flush=True)


def async_cpu_record(args_list):
    """The launcher's async run on the CPU at reduced size with the same
    clock (its staleness depends on the clock and the mask only)."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.launch import train as train_lib
    cpu_args = list(args_list)
    cpu_args[cpu_args.index("--device") + 1] = "cpu"
    cpu_args[cpu_args.index("--seq") + 1] = "32"
    return train_lib.run(get_reduced_config("qwen3-4b"),
                         train_lib.parse_args(cpu_args))


def async_slice(full, card_line):
    """Phase 18: the async path at full width, one layer, under
    torch.profiler; returns the gated kernel's launches, its in-round time,
    the layout and the rounds."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_lib
    from repro_torch.models import build_model
    cfg = dataclasses.replace(full, n_layers=ASYNC_LAYERS)
    args = train_lib.parse_args(ASYNC_ARGS)
    torch.cuda.reset_peak_memory_stats()
    for c in COUNTS:
        setattr(ops.consensus_round, c, 0)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA],
            acc_events=True) as prof:
        t0 = time.perf_counter()
        record = train_lib.run(cfg, args)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    ungated, masked, per_block = (getattr(ops.consensus_round, c)
                                  for c in COUNTS)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    in_round, busy_ms, families, top = device_profile(prof,
                                                      kernel=MASKED_NAME)
    ungated_traced = device_profile(prof)[0]
    del prof
    losses, rounds = record["losses"], record["rounds"]
    n_rounds = args.steps
    check(record["offsets"] == [1, 2], f"offsets {record['offsets']}")
    check(len(losses) == args.steps and all(map(math.isfinite, losses)),
          f"async losses {losses}")
    check(losses[-1] < losses[0], f"async loss did not fall: {losses}")
    check(len(rounds) == n_rounds, f"{len(rounds)} rounds, want {n_rounds}")
    for r in rounds:
        check(math.isfinite(r["r_max"]) and math.isfinite(r["eta_mean"]),
              f"async round metrics {r}")
        check(r["masked_launches"] == 1 and r["launches"] == 0,
              f"an async round launched {r['masked_launches']} gated and "
              f"{r['launches']} ungated kernels")
    check(ungated == 0 and masked == n_rounds and per_block == 0,
          f"async launches: {masked} gated, {ungated} ungated, {per_block} "
          f"per-block in {n_rounds} rounds")
    check(traced_ok(in_round, n_rounds) and not ungated_traced,
          f"the trace holds {len(in_round)} {MASKED_NAME} and "
          f"{len(ungated_traced)} {KERNEL_NAME} launches")
    # node 0 is 4x slow: it advances on one tick in four
    check([r["advance"][0] for r in rounds]
          == [t % 4 == 3 for t in range(n_rounds)],
          f"node 0 advanced on {[r['advance'][0] for r in rounds]}")
    cpu = async_cpu_record(ASYNC_ARGS)
    seq = [(r["stale_edges"], r["age_max"]) for r in rounds]
    cpu_seq = [(r["stale_edges"], r["age_max"]) for r in cpu["rounds"]]
    check(seq == cpu_seq, f"staleness on the card {seq}, on the CPU "
          f"{cpu_seq}")
    check(record["async"]["rounds_done"] == cpu["async"]["rounds_done"],
          f"rounds done {record['async']['rounds_done']} vs "
          f"{cpu['async']['rounds_done']}")
    check(any(s > 0 for s, _ in seq) and max(a for _, a in seq) >= 2,
          "no edge went stale")
    layout = record["layout"]
    round_s = [r["seconds"] for r in rounds]
    local_s = [t - r for t, r in zip(record["step_seconds"], round_s)]
    print(f"async slice: {cfg.arch_id} x{ASYNC_LAYERS} layer at full width, "
          f"{build_model(cfg).param_count()} parameters per node, "
          f"{layout.total} elements per node row, {len(rounds)} rounds, "
          f"gated launches {masked}, ungated {ungated}", flush=True)
    print("async local-step seconds: "
          + " ".join(f"{t:.3f}" for t in local_s) + f" [{card_line}]")
    print("async round-step seconds: "
          + " ".join(f"{t:.3f}" for t in record["step_seconds"])
          + "; rounds alone: " + " ".join(f"{t:.3f}" for t in round_s),
          flush=True)
    print("async losses: " + " ".join(f"{x:.4f}" for x in losses))
    print("async staleness (stale_edges, age_max) per round, equal to the "
          f"CPU's: {seq}; rounds done {record['async']['rounds_done']}")
    print("async rounds: " + json.dumps(rounds), flush=True)
    print(f"async kernel in rounds: median {np.median(in_round):.3f} ms "
          f"(each {', '.join(f'{t:.3f}' for t in in_round)}); peak memory "
          f"{peak_gb:.2f} GB; async_elapsed_s "
          f"{record['async']['async_elapsed_s']} [{card_line}]", flush=True)
    print(f"async trace: host {wall_ms:.1f} ms, device busy {busy_ms:.1f} "
          f"ms, idle share {1 - busy_ms / wall_ms:.4f}; device ms by family: "
          + ", ".join(f"{k} {v:.1f}" for k, v in families.items()),
          flush=True)
    for name, (n, ms) in top:
        print(f"  {ms:10.1f} ms {n:6d}x  {name[:110]}")
    check(peak_gb < 80.0, f"async peak {peak_gb:.2f} GB")
    del record
    torch.cuda.empty_cache()
    return dict(launches=masked, in_round_ms=float(np.median(in_round)),
                layout=layout)


def async_checked(full):
    """Phase 18 again, without the profiler, for two checks: on every round
    where node 0 does not advance, its parameter, lam and theta_bar_prev
    rows are bit-identical before and after; and 18c, on the first round
    whose kernel receives a non-zero staleness kick, theta', lam' and bar
    are held against the plain version in column chunks, bit for bit (r^2
    and s^2 as in phase 8). The rows, and the kernel's inputs before the
    launch, are copied into page-locked host buffers made once (the card
    has no room for them) and compared on the card chunk by chunk."""
    import torch
    from repro_torch import tree as tree_lib
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import train as train_lib
    from repro_torch.optim import consensus as cons_lib
    cfg = dataclasses.replace(full, n_layers=ASYNC_LAYERS)
    args = train_lib.parse_args(ASYNC_CHECK_ARGS)
    orig_step = cons_lib.ConsensusTrainer.consensus_step_async
    orig_launch = ops._cu.launch
    frozen, numbers, pool = [], {}, {}
    chunk = 1 << 26

    def pinned(key, like):
        if key not in pool:
            pool[key] = torch.empty(like.shape, dtype=like.dtype,
                                    pin_memory=torch.cuda.is_available())
        return pool[key]

    def node0_rows(state):
        """(node 0's row on the card, its host buffer) pairs; lam and bar
        share the buffers of the captured round's inputs."""
        return [(x[0], pinned(f"p{i}", x[0]))
                for i, x in enumerate(tree_lib.leaves(state.params))] + [
            (state.lam[0], pinned("lam", state.lam)[0]),
            (state.theta_bar_prev[0],
             pinned("bar", state.theta_bar_prev)[0])]

    def equal_on_card(x, h):
        flat_x, flat_h = x.reshape(-1), h.reshape(-1)
        return all(torch.equal(flat_x[c0:c0 + chunk],
                               flat_h[c0:c0 + chunk].to(x.device))
                   for c0 in range(0, flat_x.numel(), chunk))

    def step(self, state, probe, arrivals, advance=None):
        if advance is None or bool(advance[0]):
            return orig_step(self, state, probe, arrivals, advance)
        rows = node0_rows(state)
        for x, h in rows:
            h.copy_(x)
        new, metrics = orig_step(self, state, probe, arrivals, advance)
        frozen.append(all(equal_on_card(x, h) for (x, _), (_, h)
                          in zip(node0_rows(new), rows, strict=True)))
        return new, metrics

    def launch(theta, lam, bar_prev, wires, scales, e_sym, alpha, eta_sum,
               eta_node, block_leaf, block_size, **gates):
        kick = gates.get("kick_w")
        if numbers or kick is None or not bool((kick != 0).any()):
            return orig_launch(theta, lam, bar_prev, wires, scales, e_sym,
                               alpha, eta_sum, eta_node, block_leaf,
                               block_size, **gates)
        before = [pinned(k, x) for k, x in (("theta", theta), ("lam", lam),
                                            ("bar", bar_prev))]
        for h, x in zip(before, (theta, lam, bar_prev)):
            h.copy_(x)
        small = [x.clone() for x in (e_sym, alpha, eta_sum, eta_node)]
        gw = {k: (v.clone() if isinstance(v, torch.Tensor) else v)
              for k, v in gates.items()}
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        rsq_p, ssq_p = orig_launch(theta, lam, bar_prev, wires, scales,
                                   e_sym, alpha, eta_sum, eta_node,
                                   block_leaf, block_size, **gates)
        b.record()
        torch.cuda.synchronize()
        per_block = bool(gw.get("scales_per_block"))
        bs = block_size
        cols_per = 256 * bs          # the round's own buffers fill the card
        rsq = torch.zeros(theta.shape[0], device=theta.device)
        ssq = torch.zeros_like(rsq)
        t_plain = 0.0
        for c0 in range(0, theta.shape[1], cols_per):
            sl = slice(c0, min(c0 + cols_per, theta.shape[1]))
            cols = slice(sl.start // bs, sl.stop // bs)
            ins = [h[:, sl].to(theta.device) for h in before]
            pa = torch.cuda.Event(enable_timing=True)
            pb = torch.cuda.Event(enable_timing=True)
            pa.record()
            out = ref.consensus_round_ref(
                *ins, wires[:, :, sl],
                scales[..., cols] if per_block else scales, *small,
                block_leaf=block_leaf[cols], block_size=bs, **gw)
            pb.record()
            torch.cuda.synchronize()
            t_plain += pa.elapsed_time(pb)
            for x, y, what in zip((theta, lam, bar_prev), out[:3],
                                  ("theta'", "lam'", "bar")):
                check(torch.equal(x[:, sl], y), f"afull: {what} differs "
                      "from the plain version")
            rsq += out[3]
            ssq += out[4]
            del ins, out
        k_rs = (rsq_p.sum(dim=1), ssq_p.sum(dim=1))
        check(torch.allclose(k_rs[0], rsq, rtol=1e-4)
              and torch.allclose(k_rs[1], ssq, rtol=1e-4),
              "afull: r_sq/s_sq mismatch")
        bound_ms, by, nb, _ = round_bound(
            theta, lam, bar_prev, wires, scales, small[0], block_leaf,
            {k: v for k, v in gw.items() if k != "scales_per_block"})
        numbers.update(rel=rs_rel_err(k_rs, (rsq, ssq)),
                       ms=a.elapsed_time(b), plain_ms=t_plain,
                       bound_ms=bound_ms, bound_by=by, gb=nb / 1e9,
                       kick=gw["kick_w"].tolist())
        return rsq_p, ssq_p

    cons_lib.ConsensusTrainer.consensus_step_async = step
    ops._cu.launch = launch
    try:
        record = train_lib.run(cfg, args)
    finally:
        cons_lib.ConsensusTrainer.consensus_step_async = orig_step
        ops._cu.launch = orig_launch
    n_frozen = sum(not r["advance"][0] for r in record["rounds"])
    # node 0, 4x slow, advances on every fourth tick
    want_frozen = sum(t % 4 != 3 for t in range(args.steps))
    check(len(frozen) == n_frozen == want_frozen and all(frozen),
          f"node 0's rows moved in a round it did not advance: {frozen}")
    check(bool(numbers), "no round carried a staleness kick")
    print(f"async frozen rows: node 0 bit-identical across all {n_frozen} "
          "rounds it did not advance", flush=True)
    print(f"afull: the gated kernel on a captured async round with "
          f"staleness kicks {numbers['kick']}: theta', lam', bar bit for bit, "
          f"r2/s2 rel {numbers['rel']:.3g}; kernel {numbers['ms']:.3f} ms "
          f"(one launch, events), plain (chunked) {numbers['plain_ms']:.3f} "
          f"ms, bound {numbers['bound_ms']:.3f} ms ({numbers['bound_by']}, "
          f"{numbers['gb']:.3f} GB)", flush=True)
    del record, pool
    torch.cuda.empty_cache()
    return numbers


def agree_async_with_cpu(codec: str = "native", rtol: float = 1e-3,
                         ticks: int = 8) -> None:
    """Phase 18b: the reduced float32 async trainer (J=4, ring, the stale
    scheduler, max_staleness 1, node 0 2x slow) on the card against the
    CPU from the same weights and clock, with the ``codec`` wire: losses,
    r_max, eta and stale_edges to ``rtol``; ages, masks, advance and
    age_max exactly; the card's wire equals the CPU's encode byte for byte
    each round; every card round launches the gated kernel."""
    import torch
    from repro_torch import async_exec
    from repro_torch.configs import get_reduced_config
    from repro_torch.core.penalty import PenaltyConfig
    from repro_torch.data import DataConfig, SyntheticTokens
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.optim import ConsensusConfig, ConsensusTrainer
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.topology import TopologyConfig
    cfg = dataclasses.replace(get_reduced_config("qwen3-4b"),
                              dtype="float32")
    model = build_model(cfg)
    params1 = model.init(torch.Generator().manual_seed(0), "cpu")
    traces, exact = {}, {}
    for dev in (DEV, "cpu"):
        tr = ConsensusTrainer(
            model, num_nodes=4, device=dev, adamw=AdamWConfig(lr=1e-2),
            consensus=ConsensusConfig(
                penalty=PenaltyConfig(scheme="nap", eta0=0.1),
                topology="ring", local_steps=1, wire_codec=codec,
                dyn_topology=TopologyConfig(scheduler="stale",
                                            max_staleness=1),
                async_exec=async_exec.AsyncConfig(max_staleness=1)))
        data = SyntheticTokens(DataConfig(vocab=cfg.vocab, seq_len=32,
                                          batch_per_node=4, num_nodes=4),
                               device=dev)
        state = tr.init_state(params1)
        ex = async_exec.AsyncExecutor(tr, async_exec.RoundClock(
            compute_s=async_exec.straggler_compute(4, factor=2.0),
            wire_s=0.25, offsets=tuple(tr.offsets)))
        before = ops.consensus_round.masked_launches
        trace, ex_trace = [], []
        for step in range(ticks):
            state, m = tr.train_step(state, data.batch(step))
            if dev == DEV:
                buf = tr.layout.pack(state.params, dtype=tr.layout.wire_dtype)
                check(torch.equal(tr.codec.encode(buf).cpu(),
                                  tr.codec.encode(buf.cpu())),
                      f"async {codec}: the card's wire bytes differ from "
                      "the CPU's")
                del buf
            state, cm = ex.consensus_round(state, data.batch(10**6 + step))
            trace += [float(m["loss"]), float(cm["r_max"]),
                      float(cm["eta_mean"]), float(cm["stale_edges"])]
            ex_trace.append((state.topo.age.cpu().numpy(),
                             state.topo.mask.cpu().numpy(),
                             float(cm["age_max"])))
        if dev == DEV:
            check(ops.consensus_round.masked_launches - before == ticks,
                  "the card's async rounds did not all launch the gated "
                  "kernel")
        traces[dev] = np.asarray(trace)
        exact[dev] = (ex_trace, ex.summary()["rounds_done"])
    card, cpu = traces[DEV], traces["cpu"]
    rel = float(np.max(np.abs(card - cpu) / np.maximum(np.abs(cpu), 1e-12)))
    check(bool(np.all(np.isfinite(card))) and rel < rtol,
          f"async {codec} card vs cpu trace: {card.tolist()} vs "
          f"{cpu.tolist()}")
    (c_tr, c_done), (p_tr, p_done) = exact[DEV], exact["cpu"]
    check(c_done == p_done and all(
        np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
        and a[2] == b[2] for a, b in zip(c_tr, p_tr)),
        f"async {codec}: ages, masks or rounds differ between card and CPU")
    # 2x slow at a bound of 1: ages reach 1 (held payloads are consumed,
    # damped) and never pass the bound
    check(max(t[2] for t in c_tr) == 1, "no held payload was consumed")
    print(f"aagree: reduced float32 async trainer, {codec} wire, {ticks} "
          f"ticks, rounds done {c_done}, card vs cpu max relative difference "
          f"{rel:.3g}, ages, masks and wire bytes equal", flush=True)


def async_zero_is_sync(steps: int = 3) -> None:
    """Phase 18b: on the card, ``max_staleness=0`` through the executor
    equals the synchronous trainer bit for bit."""
    import torch
    from repro_torch import async_exec
    from repro_torch import tree as tree_lib
    from repro_torch.configs import get_reduced_config
    from repro_torch.core.penalty import PenaltyConfig
    from repro_torch.data import DataConfig, SyntheticTokens
    from repro_torch.models import build_model
    from repro_torch.optim import ConsensusConfig, ConsensusTrainer
    from repro_torch.optim.adamw import AdamWConfig
    cfg = dataclasses.replace(get_reduced_config("qwen3-4b"),
                              dtype="float32")
    model = build_model(cfg)
    params1 = model.init(torch.Generator().manual_seed(1), "cpu")
    states = []
    for zero in (False, True):
        tr = ConsensusTrainer(
            model, num_nodes=4, device=DEV, adamw=AdamWConfig(lr=1e-2),
            consensus=ConsensusConfig(
                penalty=PenaltyConfig(scheme="nap", eta0=0.1),
                topology="ring", local_steps=1,
                async_exec=(async_exec.AsyncConfig(max_staleness=0)
                            if zero else None)))
        data = SyntheticTokens(DataConfig(vocab=cfg.vocab, seq_len=32,
                                          batch_per_node=4, num_nodes=4),
                               device=DEV)
        state = tr.init_state(params1)
        ex = async_exec.AsyncExecutor(tr) if zero else None
        for step in range(steps):
            state, _ = tr.train_step(state, data.batch(step))
            probe = data.batch(10**6 + step)
            state, _ = ex.consensus_round(state, probe) if zero \
                else tr.consensus_step(state, probe)
        states.append(state)
    a, b = states
    same = all(torch.equal(u, v) for u, v in zip(
        tree_lib.leaves(a.params), tree_lib.leaves(b.params), strict=True))
    same &= torch.equal(a.lam, b.lam) and torch.equal(
        a.theta_bar_prev, b.theta_bar_prev) and torch.equal(
            a.penalty.eta, b.penalty.eta)
    check(same, "max_staleness=0 through the executor differs from the "
          "synchronous round on the card")
    print(f"aagree: max_staleness=0 through the executor equals the sync "
          f"trainer on the card bit for bit ({steps} rounds)", flush=True)


OBS_FLAGS = ["--obs-ring-cap", "4", "--obs-drain-every", "4", "--health"]
OBS_SPANS = ("consensus/pack", "consensus/probe", "consensus/fused_round",
             "consensus/penalty", "wire/encode", "wire/decode")
SYNC_WARNING = "synchronizing CUDA operation"


def obs_launch(cfg, args_list, obs_dir, profile=False):
    """``launch.train.run`` of ``cfg`` with ``args_list`` and, when
    ``obs_dir`` is given, ``--obs-dir obs_dir`` and ``OBS_FLAGS`` (with
    ``profile``, ``--profile-rounds 2`` too).
    Every round runs under ``torch.cuda.set_sync_debug_mode("warn")``: the
    synchronising calls it makes are counted per round. Returns the run's
    record, those counts, the last round's state and the seconds of each
    obs drain."""
    import warnings

    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_lib
    from repro_torch.obs import export as obs_export
    from repro_torch.optim import consensus as cons_lib
    argv = list(args_list)
    if obs_dir:
        argv += ["--obs-dir", obs_dir] + OBS_FLAGS
    if profile:
        argv += ["--profile-rounds", "2"]
    args = train_lib.parse_args(argv)
    name = "consensus_step_async" if args.async_mode else "consensus_step"
    orig_step = getattr(cons_lib.ConsensusTrainer, name)
    orig_drain = obs_export.ObsWriter.drain
    syncs, last, drain_s = [], [], []

    def step(self, *a, **kw):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = orig_step(self, *a, **kw)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        syncs.append(sum(SYNC_WARNING in str(w.message) for w in caught))
        last[:] = [out[0]]
        return out

    def drain(self, state, *, step):
        t0 = time.perf_counter()
        n = orig_drain(self, state, step=step)
        drain_s.append(time.perf_counter() - t0)
        return n

    for c in COUNTS:
        setattr(ops.consensus_round, c, 0)
    setattr(cons_lib.ConsensusTrainer, name, step)
    obs_export.ObsWriter.drain = drain
    try:
        record = train_lib.run(cfg, args)
    finally:
        setattr(cons_lib.ConsensusTrainer, name, orig_step)
        obs_export.ObsWriter.drain = orig_drain
    torch.cuda.synchronize()
    return record, syncs, last[0], drain_s


def state_to_host(state):
    """The parts of a state that obs must leave untouched, on the host:
    the parameter replicas, lam, eta and the mask."""
    from repro_torch import tree as tree_lib
    return [x.cpu() for x in tree_lib.leaves(state.params)] + [
        state.lam.cpu(), state.penalty.eta.cpu(), state.topo.mask.cpu()]


def equal_to_host(state, host, chunk=1 << 26) -> bool:
    """Whether ``state`` equals the host copy ``host`` bit for bit,
    compared on the card chunk by chunk."""
    from repro_torch import tree as tree_lib
    dev = tree_lib.leaves(state.params) + [
        state.lam, state.penalty.eta, state.topo.mask]
    for x, h in zip(dev, host, strict=True):
        fx, fh = x.reshape(-1), h.reshape(-1)
        if fx.dtype != fh.dtype or fx.numel() != fh.numel():
            return False
        for c0 in range(0, fx.numel(), chunk):
            if not bool((fx[c0:c0 + chunk]
                         == fh[c0:c0 + chunk].to(x.device)).all()):
                return False
    return True


def kernels_under_span(trace_path, kernel, span):
    """(kernels of ``kernel`` in a Chrome trace, those launched inside the
    host range ``span``): a kernel counts when the CUDA API call that
    launched it (the same ``correlation``) lies inside a ``span``
    range, or when the kernel lies inside the device-side projection of
    that range (``gpu_user_annotation``)."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"
               and kernel in e.get("name", "")]
    cpu_spans = [(e["ts"], e["ts"] + e["dur"]) for e in events
                 if e.get("cat") == "user_annotation"
                 and e.get("name") == span]
    gpu_spans = [(e["ts"], e["ts"] + e["dur"]) for e in events
                 if e.get("cat") == "gpu_user_annotation"
                 and e.get("name") == span]
    calls = {e["args"]["correlation"]: e for e in events
             if e.get("cat") in ("cuda_runtime", "cuda_driver")
             and "correlation" in e.get("args", {})}
    inside = 0
    for k in kernels:
        call = calls.get(k.get("args", {}).get("correlation"))
        if (call is not None and any(t0 <= call["ts"] <= t1
                                     for t0, t1 in cpu_spans)) or any(
                t0 <= k["ts"] and k["ts"] + k["dur"] <= t1
                for t0, t1 in gpu_spans):
            inside += 1
    names = {e.get("name") for e in events
             if e.get("cat") == "user_annotation"}
    return kernels, inside, names


def read_jsonl(path):
    with open(path) as f:
        return [json.loads(ln) for ln in f if ln.strip()]


def obs_slice(tag, full, args_list, card_line, same_shape_ms):
    """Phases 19 and 19b: the path of ``args_list`` on qwen3-4b at full
    width (``full``), one layer, four times in turns: obs off, obs on
    (``--obs-dir`` in a temporary directory, ``OBS_FLAGS``, two rounds
    profiled), obs on unprofiled, obs off. On the profiled run, checks:
    one gated launch per round; the drained rows' r_max and
    eta_mean equal to the rounds' own, bit for bit, and the node ring's
    max over live nodes of r equal to r_max; the journal; the profile
    trace's spans, with the gated kernel launched inside
    consensus/fused_round; the port's validator and dashboard check; obs
    on and off bit-identical in params, lam, eta and mask. Over the four
    runs: as many synchronising calls in each obs-on round as in the
    obs-off round, and the obs-on step medians within 1.10x of the obs-off
    ones. Returns the profiled obs-on run's gated launches."""
    import tempfile

    import torch
    from repro_torch.kernels import ops
    from repro_torch.obs import dashboard, export as obs_export, schema
    cfg = dataclasses.replace(full, n_layers=OBS_LAYERS)
    torch.cuda.empty_cache()
    off, off_syncs, state, _ = obs_launch(cfg, args_list, "")
    off_host = state_to_host(state)
    del state
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        d = os.path.join(tmp, "obs")
        record, syncs, state, drain_s = obs_launch(cfg, args_list, d,
                                                   profile=True)
        same = equal_to_host(state, off_host)
        ring_b = state.ring.buf.numel() * 4
        node_b = state.node_ring.buf.numel() * 4
        del state, off_host
        torch.cuda.empty_cache()
        rounds = record["rounds"]
        n = len(rounds)
        masked = ops.consensus_round.masked_launches
        check(all(r["masked_launches"] == 1 and r["launches"] == 0
                  for r in rounds) and masked == n,
              f"{tag}: {masked} gated launches in {n} rounds")
        rows = read_jsonl(os.path.join(d, "metrics.jsonl"))
        nrows = read_jsonl(os.path.join(d, "node_metrics.jsonl"))
        events = read_jsonl(os.path.join(d, "events.jsonl"))
        check(len(rows) == len(nrows) == n and all(
            x[k] == r[k] for x, r in zip(rows, rounds)
            for k in ("r_max", "eta_mean")),
            f"{tag}: drained rows differ from the rounds' metrics")
        check([x["step"] for x in rows] == [t + 1 for t in range(n)],
              f"{tag}: step stamps {[x['step'] for x in rows]}")
        for x, nr in zip(rows, nrows):
            live = [r for r, a, v in zip(nr["r"], nr["alive"],
                                         nr["advance"]) if a and v]
            check(max(live) == x["r_max"],
                  f"{tag}: node ring max r {max(live)} vs r_max "
                  f"{x['r_max']}")
        trace = record["profile"]
        kernels, inside, names = kernels_under_span(
            trace, MASKED_NAME, "consensus/fused_round")
        round_span = "round/async" if "--async" in args_list \
            else "round/sync"
        check(set(OBS_SPANS) | {round_span} <= names
              and any(s.startswith("consensus/exchange/off") for s in names),
              f"{tag}: the profile lacks spans: "
              f"{sorted(set(OBS_SPANS) - names)}")
        check(1 <= inside == len(kernels) <= 2,
              f"{tag}: {inside} of {len(kernels)} traced {MASKED_NAME} "
              "launches inside consensus/fused_round")
        kernel_ms = [k["dur"] / 1e3 for k in kernels]
        report = obs_export.validate_obs_dir(d)
        check(report["ok"], f"{tag}: validator {report['errors']}")
        dash = dashboard.check_dashboard(dashboard.render_dashboard(d))
        check(dash["ok"], f"{tag}: dashboard {dash['errors']}")
        rollup = record["obs"]
        check(rollup["dropped_rows"] == 0 and "health" in rollup,
              f"{tag}: rollup {rollup['dropped_rows']} dropped, health "
              f"{'health' in rollup}")
        clock_ok = None
        if "--async" in args_list:
            with open(os.path.join(d, "roundclock_trace.json")) as f:
                doc = json.load(f)
            clock_ok = report["files"]["roundclock_trace.json"]["present"] \
                and bool(doc["traceEvents"])
            check(clock_ok, f"{tag}: no round clock trace")
            adv = [nr["advance"][0] for nr in nrows]
            check(adv == [float(t % 4 == 3) for t in range(n)]
                  and adv == [float(r["advance"][0]) for r in rounds],
                  f"{tag}: node 0 advanced on {adv}")
        else:
            check({"step": 8, "event": "node_dropped", "node": 1} in events,
                  f"{tag}: node 1's drop is not in the journal: {events}")
    check(same, f"{tag}: obs on and off differ in params, lam, eta or mask")
    with tempfile.TemporaryDirectory() as tmp:
        on2, syncs2, state, _ = obs_launch(cfg, args_list,
                                           os.path.join(tmp, "obs"))
        del state
    torch.cuda.empty_cache()
    off2, off_syncs2, state, _ = obs_launch(cfg, args_list, "")
    del state
    torch.cuda.empty_cache()
    check(syncs == syncs2 == off_syncs == off_syncs2,
          f"{tag}: synchronising calls per round with obs {syncs}, "
          f"{syncs2}, without {off_syncs}, {off_syncs2}")
    runs = {"off": off, "on (profiled)": record, "on": on2, "off again": off2}
    meds = {}
    for k, rec in runs.items():
        step_s = rec["step_seconds"]
        round_s = [r["seconds"] for r in rec["rounds"]]
        meds[k] = [float(np.median(x)) for x in (
            step_s, [t - r for t, r in zip(step_s, round_s)], round_s)]
    med_on = (meds["on (profiled)"][0] + meds["on"][0]) / 2
    med_off = (meds["off"][0] + meds["off again"][0]) / 2
    ratio = med_on / med_off
    check(ratio <= 1.10, f"{tag}: obs-on step median {med_on:.4f} s is "
          f"{ratio:.3f}x obs-off's {med_off:.4f} s")
    print(f"{tag}: {n} rounds, gated launches {masked}, obs on/off "
          f"bit-identical in params, lam, eta, mask; rows {len(rows)}, "
          f"node rows {len(nrows)}, events {len(events)}, dropped 0; "
          f"validator and dashboard ok; spans in the profile: "
          f"{sorted(s for s in names if '/' in s)}", flush=True)
    for k, rec in runs.items():
        print(f"{tag} {k}: step / local step / round median seconds "
              + " / ".join(f"{t:.4f}" for t in meds[k]) + "; steps "
              + " ".join(f"{t:.3f}" for t in rec["step_seconds"]),
              flush=True)
    print(f"{tag}: obs-on step median {med_on:.4f} s (mean of its two runs), "
          f"obs-off {med_off:.4f} s, ratio {ratio:.4f} (target 1.03); the "
          f"unprofiled obs-on run alone {meds['on'][0] / med_off:.4f} "
          f"[{card_line}]", flush=True)
    print(f"{tag}: rings {ring_b} + {node_b} bytes (cap 4, J 3; "
          f"{schema.NUM_COLUMNS * 4} and {3 * schema.NUM_NODE_COLUMNS * 4} "
          f"bytes per round); drains {len(drain_s)}, ms each "
          f"{', '.join(f'{1e3 * t:.3f}' for t in drain_s)}; synchronising "
          f"calls per round, obs on {syncs}, off {off_syncs}; gated kernel "
          f"in the {len(kernels)} profiled rounds "
          f"{', '.join(f'{t:.3f}' for t in kernel_ms)} ms, {inside} inside "
          f"consensus/fused_round (the same path without obs, in its own "
          f"phase: {same_shape_ms:.3f} ms); health "
          f"{[x['score'] for x in rollup['health']['nodes']]}"
          + ("" if clock_ok is None else "; round clock trace ok"),
          flush=True)
    return masked


def state_copy(x, dev):
    """A copy of a state (tensors, dicts and named tuples of them) on
    ``dev``."""
    import torch
    if isinstance(x, torch.Tensor):
        return x.to(dev, copy=True)
    if isinstance(x, dict):
        return {k: state_copy(v, dev) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(state_copy(v, dev) for v in x))
    return x


def agree_obs_with_cpu(kind: str, codec: str = "native", rounds: int = 6,
                       rtol: float = 1e-3, shared: bool = False) -> None:
    """Phase 19c: the reduced float32 trainer with obs on, on the card and
    on the CPU from the same weights (``kind`` ``dynamic``: J=4, complete,
    budget scheduler with churn, node 1 dropped after round 2; ``async``:
    J=4, ring, stale scheduler, max_staleness 1, node 0 2x slow), the two
    in lockstep, draining both rings every 2 rounds: the rows' step stamps,
    age_max, alive, advance and wire bytes equal, the other columns within
    ``rtol``; the journal's events equal, their floats within ``rtol``.
    With ``shared`` the CPU starts each round from a copy of the card's
    state after its local step, so that round-off does not compound over
    the rounds."""
    import torch
    from repro_torch import async_exec, obs
    from repro_torch.configs import get_reduced_config
    from repro_torch.core.penalty import PenaltyConfig
    from repro_torch.data import DataConfig, SyntheticTokens
    from repro_torch.models import build_model
    from repro_torch.obs import node_ring as obs_node_ring
    from repro_torch.optim import ConsensusConfig, ConsensusTrainer
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.topology import TopologyConfig
    cfg = dataclasses.replace(get_reduced_config("qwen3-4b"),
                              dtype="float32")
    model = build_model(cfg)
    params1 = model.init(torch.Generator().manual_seed(0), "cpu")
    asy = kind == "async"
    sides = []                                     # the card's side first
    for dev in (DEV, "cpu"):
        tr = ConsensusTrainer(
            model, num_nodes=4, device=dev, adamw=AdamWConfig(lr=1e-2),
            consensus=ConsensusConfig(
                penalty=PenaltyConfig(scheme="nap", eta0=0.1,
                                      budget_init=1.0 if asy else 0.1),
                topology="ring" if asy else "complete", local_steps=1,
                wire_codec=codec,
                dyn_topology=(TopologyConfig(scheduler="stale",
                                             max_staleness=1) if asy else
                              TopologyConfig(scheduler="budget", churn=True,
                                             gate_tol=10.0)),
                async_exec=async_exec.AsyncConfig(max_staleness=1)
                if asy else None,
                obs=obs.ObsConfig(ring_capacity=4, drain_every=2)))
        data = SyntheticTokens(DataConfig(vocab=cfg.vocab, seq_len=32,
                                          batch_per_node=4, num_nodes=4),
                               device=dev)
        state = tr.init_state(params1)
        ex = async_exec.AsyncExecutor(tr, async_exec.RoundClock(
            compute_s=async_exec.straggler_compute(4, factor=2.0),
            wire_s=0.25, offsets=tuple(tr.offsets))) if asy else None
        journal = obs.EventJournal(os.devnull,
                                   max_staleness=1 if asy else None)
        journal.observe(state.topo, state.penalty, step=0)
        sides.append(dict(tr=tr, data=data, state=state, ex=ex,
                          journal=journal, cur=0, ncur=0, rows=[], nrows=[],
                          events=[]))
    for step in range(rounds):
        card = None
        for sd in sides:
            tr, state = sd["tr"], sd["state"]
            if shared and card is not None:
                state = state_copy(card, "cpu")
            else:
                state, _ = tr.train_step(state, sd["data"].batch(step))
            if shared and card is None:
                card = state_copy(state, "cpu")
            probe = sd["data"].batch(10**6 + step)
            state, _ = sd["ex"].consensus_round(state, probe) if asy \
                else tr.consensus_step(state, probe)
            if (step + 1) % 2 == 0:
                r, sd["cur"], _ = obs.drain(state.ring, sd["cur"])
                nr, sd["ncur"], _ = obs_node_ring.drain(state.node_ring,
                                                        sd["ncur"])
                sd["rows"].append(r)
                sd["nrows"].append(nr)
                sd["events"] += sd["journal"].observe(
                    state.topo, state.penalty, step=step + 1)
            if not asy and step == 2:
                state = tr.apply_churn(state, 1)
            sd["state"] = state
    got = []
    for sd in sides:
        sd["journal"].close()
        got.append((np.concatenate(sd["rows"]), np.concatenate(sd["nrows"]),
                    sd["events"]))
    del sides
    (c_rows, c_nodes, c_ev), (p_rows, p_nodes, p_ev) = got
    exact_rows = [obs.COLUMN_INDEX[k] for k in ("step", "age_max")]
    exact_nodes = [obs.NODE_COLUMN_INDEX[k] for k in (
        "step", "age_max", "alive", "advance", "wire_rx_bytes")]

    def rel(a, b, skip, names):
        """(largest relative difference, where) over the float columns."""
        err = np.abs(a.astype(np.float64) - b) / np.maximum(np.abs(b), 1e-12)
        err[..., skip] = 0.0
        at = np.unravel_index(int(np.argmax(err)), err.shape)
        return float(err[at]), (
            f"{names[at[-1]]} at {tuple(int(i) for i in at[:-1])}: card "
            f"{float(a[at])!r}, cpu {float(b[at])!r}")

    check(np.array_equal(c_rows[:, exact_rows].view(np.int32),
                         p_rows[:, exact_rows].view(np.int32))
          and np.array_equal(c_nodes[..., exact_nodes].view(np.int32),
                             p_nodes[..., exact_nodes].view(np.int32)),
          f"obs agree {kind} {codec}: step, age, alive, advance or wire "
          "bytes differ between card and CPU")
    worst, where = max(rel(c_rows, p_rows, exact_rows, obs.RING_COLUMNS),
                       rel(c_nodes, p_nodes, exact_nodes, obs.NODE_COLUMNS))
    check(worst < rtol, f"obs agree {kind} {codec}: card vs cpu rows "
          f"{worst:.3g} apart ({where})")
    same_ev = len(c_ev) == len(p_ev) and all(
        set(a) == set(b) and all(
            (abs(a[k] - b[k]) <= rtol * abs(b[k]))
            if isinstance(b[k], float) else a[k] == b[k] for k in b)
        for a, b in zip(c_ev, p_ev))
    check(same_ev, f"obs agree {kind} {codec}: events {c_ev} vs {p_ev}")
    print(f"obs agree: reduced float32 {kind} trainer, {codec} wire, "
          f"{rounds} rounds drained every 2"
          + (", each round from the card's state" if shared else "")
          + ": rows card vs cpu max relative "
          f"difference {worst:.3g} ({where}), exact columns equal, "
          f"{len(c_ev)} journal events equal", flush=True)


def all_counters():
    """(wrapper, attribute) of every kernel's launch counter."""
    from repro_torch.kernels import ops
    return ([(ops.consensus_round, c) for c in COUNTS]
            + [(ops.consensus_update, "launches"),
               (ops.flash_attention, "launches"),
               (ops.flash_attention, "tc_launches"),
               (ops.rwkv6_scan, "launches")])


def attn_pairs(s: int, causal: bool, window: int) -> int:
    """The (query, key) pairs that the mask lets through."""
    q, k = np.arange(s)[:, None], np.arange(s)[None, :]
    keep = np.ones((s, s), bool)
    if causal:
        keep &= k <= q
    if window > 0:
        keep &= k > q - window
    return int(keep.sum())


def flash_case(name, card_line, *, kv=32, dtype="bfloat16", window=0,
               seed=0, b=4, h=32, s=512, hd=128, model_layout=False):
    """Phase 9: the routed flash kernel on head-major inputs against its
    plain version (K/V repeated to the query heads); it, the cc kernel on
    the same inputs (when the route is the tensor-core one), the plain
    version and the library's attention are timed; atol 2e-5 in float32,
    2e-2 in bf16. The bound of f32 inputs counts three TF32 products a
    term at the TF32 rate (``bound_f32_rate_ms``: the f32 rate's). With
    ``model_layout`` the kernel is also called as the serve path calls it,
    through ``ops.flash_attention`` on [B, S, H, hd] tensors (K/V
    repeated, as the model does), and held to the same plain version.

    In bf16 the kernel is held against the plain version evaluated in f32
    on the same inputs and cast to bf16: that is the TPU kernel's
    arithmetic (q, k, v widened to f32 inside), save that the tensor-core
    kernel rounds p to bf16 for its p.v product. The plain version in bf16
    rounds its logits and probabilities to bf16 as well; its distance to
    the kernel is printed beside."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    dt = getattr(torch, dtype)
    route = fa.route(dt, hd)
    g = torch.Generator(device=DEV).manual_seed(seed)
    q, k, v = (torch.randn(b, n, s, hd, generator=g, device=DEV).to(dt)
               for n in (h, kv, kv))
    kr = k.repeat_interleave(h // kv, dim=1)
    vr = v.repeat_interleave(h // kv, dim=1)
    kw = dict(causal=True, window=window)
    want = ref.flash_attention_ref(q.float(), kr.float(), vr.float(),
                                   **kw).to(dt)
    plain = ref.flash_attention_ref(q, kr, vr, **kw)
    got = fa.launch(q, k, v, layout="bhsd", **kw)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    err_plain = float((got.float() - plain.float()).abs().max())
    tol = 2e-5 if dtype == "float32" else 2e-2
    check(got.shape == q.shape and got.dtype == dt and err <= tol,
          f"flash {name}: max abs error {err:.3g} against the plain version "
          f"(tolerance {tol})")
    if model_layout:
        from repro_torch.kernels import ops
        qm, km, vm = (x.transpose(1, 2).contiguous() for x in (q, kr, vr))
        before = (ops.flash_attention.launches,
                  ops.flash_attention.tc_launches)
        got_m = ops.flash_attention(qm, km, vm, **kw)
        torch.cuda.synchronize()
        launched = (ops.flash_attention.launches - before[0],
                    ops.flash_attention.tc_launches - before[1])
        # a check, not the path
        ops.flash_attention.launches, ops.flash_attention.tc_launches = before
        err_m = float((got_m.float()
                       - want.transpose(1, 2).float()).abs().max())
        check(launched == (1, int(route == "tc")) and got_m.shape == qm.shape
              and got_m.dtype == dt and err_m <= tol,
              f"flash {name} [B, S, H, hd] through ops: launches (all, "
              f"tensor-core) {launched}, max abs error {err_m:.3g} against "
              f"the plain version (tolerance {tol})")
        print(f"flash {name} [B, S, H, hd] through ops.flash_attention: "
              f"max_abs_err={err_m:.3g}", flush=True)
        del qm, km, vm, got_m
    del got, want, plain
    k_ms = time_device(lambda: fa.launch(q, k, v, layout="bhsd", **kw),
                       reps=50)
    cc_ms = None
    if route == "tc":
        cc_ms = time_device(lambda: fa.launch(q, k, v, layout="bhsd",
                                              kernel="cc", **kw), reps=20)
    p_ms = time_cuda(lambda: ref.flash_attention_ref(q, kr, vr, **kw),
                     reps=5)
    if window:
        qp = torch.arange(s, device=DEV)[:, None]
        kp = torch.arange(s, device=DEV)[None, :]
        mask = (kp <= qp) & (kp > qp - window)

        def lib():
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                  enable_gqa=kv < h)
    else:
        def lib():
            return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                  enable_gqa=kv < h)
    out = lib()
    torch.cuda.synchronize()
    check(out.shape == q.shape and bool(torch.isfinite(out).all()),
          f"flash {name}: the library's output")
    del out
    l_ms = time_device(lib, reps=50)
    by = sum(nbytes(t) for t in (q, k, v)) + nbytes(q)
    flops = 4 * b * h * hd * attn_pairs(s, True, window)
    t_b = by / HBM_BYTES_PER_S * 1e3
    if dtype == "bfloat16":
        t_o = flops / BF16_FLOPS_PER_S * 1e3
        old_txt, t_f32 = "", None
    else:
        # f32 products on the tensor cores in three TF32 parts; beside it
        # the bound at the CUDA cores' f32 rate that PERF.md used until
        # the kernel took the tensor cores
        t_o = F32_TF32_PARTS * flops / TF32_FLOPS_PER_S * 1e3
        t_f32 = max(t_b, flops / F32_OPS_PER_S * 1e3)
        old_txt = f"; at the f32 rate {t_f32:.4f} ms"
    bound_by = "bytes" if t_b >= t_o else "operations"
    cc_txt = ("" if cc_ms is None else
              f"cc kernel {cc_ms:.4f} ms ({cc_ms / k_ms:.2f}x), ")
    print(f"flash {name}: B {b} S {s} heads {h}/{kv} hd {hd} {dtype} causal"
          f" window {window}: {route} kernel, max_abs_err={err:.3g} (to the "
          f"plain version in {dtype} {err_plain:.3g}); kernel {k_ms:.4f} ms,"
          f" {cc_txt}plain {p_ms:.4f} ms, library {l_ms:.4f} ms "
          f"({k_ms / l_ms:.2f}x), bound {max(t_b, t_o):.4f} ms ({bound_by}: "
          f"{by / 1e6:.1f} MB, {flops / 1e9:.3f} GFLOP{old_txt}) "
          f"[{card_line}]", flush=True)
    del q, k, v, kr, vr
    torch.cuda.empty_cache()
    return dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms, cc_ms=cc_ms,
                bound_ms=max(t_b, t_o), bound_by=bound_by, library_ms=l_ms,
                bound_f32_rate_ms=t_f32, route=route)


def check_tc_against_library(name, rec):
    """Phases 9 and 20: the tensor-core kernel at most TC_LIBRARY_RATIO
    times the library's attention on the same inputs, timed in the same
    run (the cc kernel's time is printed beside, ungated)."""
    check(rec["route"] == "tc"
          and rec["ms"] <= TC_LIBRARY_RATIO * rec["library_ms"],
          f"flash {name}: the {rec['route']} kernel took {rec['ms']:.4f} ms, "
          f"the library {rec['library_ms']:.4f} ms on the same inputs (want "
          f"the tensor-core kernel at most {TC_LIBRARY_RATIO}x the library)")


def scan_case(dtype, card_line, *, seed=0, b=4, t=512, h=64, hd=64,
              chunk=32):
    """Phase 10: the scan kernel on model-layout inputs against its plain
    version, both timed; y within 3e-5 (float32) or 8e-3 (bf16) of max|y|,
    the f32 state within the same share of max|state|; the launch's blocks,
    shared bytes per block and blocks per SM printed beside."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import rwkv6_scan as rw
    dt = getattr(torch, dtype)
    g = torch.Generator(device=DEV).manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=DEV) * scale

    r, k, v = (rnd(b, t, h, hd, scale=sc).to(dt) for sc in (1.0, 0.5, 1.0))
    log_w = torch.log(torch.clamp_min(
        torch.exp(-torch.exp(rnd(b, t, h, hd, scale=0.5))), 1e-38))
    u = rnd(h, hd, scale=0.1).to(dt)
    s0 = rnd(b, h, hd, hd, scale=0.1)
    heads = [x.transpose(1, 2) for x in (r, k, v, log_w)]
    y_want, s_want = ref.rwkv6_scan_ref(*heads, u, s0)
    y, s = rw.launch(r, k, v, log_w, u, s0, chunk=chunk)
    torch.cuda.synchronize()
    rtol = 3e-5 if dtype == "float32" else 8e-3
    scale = float(y_want.float().abs().max()) + 1e-6
    s_scale = float(s_want.abs().max()) + 1e-6
    err_y = float((y.float() - y_want.transpose(1, 2).float()).abs().max())
    err_s = float((s - s_want).abs().max())
    check(err_y <= rtol * scale and err_s <= rtol * s_scale,
          f"scan {dtype}: y error {err_y:.3g} (max|y| {scale:.3g}), state "
          f"error {err_s:.3g} (max|state| {s_scale:.3g})")
    del y, s, y_want, s_want
    k_ms = time_device(lambda: rw.launch(r, k, v, log_w, u, s0, chunk=chunk),
                       reps=20)
    shape = rw.info(dt, hd, chunk)
    p_ms = time_cuda(lambda: ref.rwkv6_scan_ref(*heads, u, s0), reps=3,
                     warmup=1)
    es = r.element_size()
    by = (b * t * h * hd * (4 * es + 4) + 2 * nbytes(s0) + nbytes(u))
    # per chunk of C: C hd^2 multiply-adds for the inter-chunk term and as
    # many for the state update; C(C-1)/2 hd for the strictly lower scores,
    # C hd for the diagonal bonus and C(C+1)/2 hd for their product with v
    flops = b * t * h * 2 * (2 * hd * hd + (chunk + 1) * hd)
    t_b = by / HBM_BYTES_PER_S * 1e3
    t_o = flops / F32_OPS_PER_S * 1e3
    bound_by = "bytes" if t_b >= t_o else "operations"
    print(f"scan {dtype}: B {b} T {t} heads {h} hd {hd} chunk {chunk}: "
          f"max_abs_err y {err_y:.3g} (max|y| {scale:.3g}) state "
          f"{err_s:.3g} (max|state| {s_scale:.3g}); kernel {k_ms:.4f} ms, "
          f"plain {p_ms:.4f} ms, bound "
          f"{max(t_b, t_o):.4f} ms ({bound_by}: {by / 1e9:.3f} GB, "
          f"{flops / 1e9:.3f} GFLOP f32); {b * h * shape['blocks_per_head']}"
          f" blocks of {shape['threads']} threads, "
          f"{shape['blocks_per_head']} per (batch, head), "
          f"{shape['smem_bytes']} shared bytes and {shape['registers']} "
          f"registers a thread, {shape['blocks_per_sm']} blocks per SM "
          f"[{card_line}]", flush=True)
    del r, k, v, log_w, heads
    torch.cuda.empty_cache()
    return dict(max_abs_err=err_y, ms=k_ms, plain_ms=p_ms,
                bound_ms=max(t_b, t_o), bound_by=bound_by, **shape)


def serve_slice(arch, card_line):
    """Phase 11: ``launch.serve.run`` at full width, ``SERVE_LAYERS``
    deep (every counter from 0), then one more prefill and 8 decode steps
    of the same model under the profiler (the profiler's own host cost
    would inflate the served run's times). Returns the kernel's launches
    and its median time per launch in the traced prefill."""
    import gc
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import build_model
    cfg = dataclasses.replace(get_config(arch), n_layers=SERVE_LAYERS[arch])
    args = serve.parse_args(["--arch", arch] + SERVE_ARGS)
    # the path's kernel: bf16 attention at hd 128 is the tensor-core one
    kernel, trace_name = (("rwkv6_scan", SCAN_NAME) if cfg.rwkv
                          else ("flash_attention", FLASH_TC_NAME))
    n = cfg.n_layers
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base_gb = torch.cuda.memory_allocated() / 1e9
    for obj, attr in all_counters():
        setattr(obj, attr, 0)
    t0 = time.perf_counter()
    record = serve.run(cfg, args)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = {f"{obj.__name__}.{attr}": getattr(obj, attr)
              for obj, attr in all_counters()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    path = ({f"{kernel}.launches"} if cfg.rwkv else
            {f"{kernel}.launches", f"{kernel}.tc_launches"})
    want = {c: (n if c in path else 0) for c in counts}
    check(counts == want, f"serve {arch}: launches {counts}, want {want}")
    check(record["prefill_launches"][kernel] == n
          and not any(record["decode_launches"].values()),
          f"serve {arch}: prefill launches {record['prefill_launches']}, "
          f"decode launches {record['decode_launches']}")
    logits = record["prefill_logits"]
    b, s = args.batch, args.prompt_len
    check(tuple(logits.shape) == (b, s, cfg.vocab)
          and bool(torch.isfinite(logits).all()),
          f"serve {arch}: prefill logits {tuple(logits.shape)}")
    toks = record["tokens"]
    check(tuple(toks.shape) == (b, args.gen_len)
          and int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab,
          f"serve {arch}: tokens {tuple(toks.shape)}")
    last = logits[:, -1].float()
    rep = record["replay_logits"].float()
    diff = float((last - rep).abs().max())
    scale = float(rep.abs().max())
    bound = n * 2.0 ** -8
    top1 = float((last.argmax(-1) == rep.argmax(-1)).float().mean())
    params = record["params"]
    # the witness: the plain prefill (use_kernel=False) of the same weights
    # and prompts, held against the same replay
    with torch.inference_mode():
        plain = build_model(cfg).prefill(params, {"tokens": record["prompts"]},
                                         use_kernel=False)[:, -1].float()
    diff_plain = float((plain - rep).abs().max())
    diff_kp = float((plain - last).abs().max())
    top1_plain = float((plain.argmax(-1) == rep.argmax(-1)).float().mean())
    print(f"serve {arch} prefill vs replay: last logits max |diff| "
          f"{diff:.4g}, {diff / scale:.4g} of max|logit| {scale:.4g}, top-1 "
          f"agreement {top1:.2f}; the plain prefill vs replay {diff_plain:.4g}"
          f" ({diff_plain / scale:.4g}), top-1 {top1_plain:.2f}; kernel vs "
          f"plain prefill {diff_kp:.4g} ({diff_kp / scale:.4g}); tokens "
          f"{toks[0, :8].tolist()}", flush=True)
    del plain
    if cfg.rwkv:
        # random-weight RWKV6 magnifies round-off with depth (the
        # reference's own f32 prefill and replay differ by 8e-6, 4e-4 and
        # 1.4e-3 of max|logit| at 4, 16 and 32 layers), so in bf16 the
        # replay bounds both prefills loosely: the kernel's prefill may stray
        # from it at most twice as far as the plain prefill does, and its
        # time-mix is held against the plain recurrence layer by layer
        check(diff <= 2 * diff_plain,
              f"serve {arch}: prefill vs replay last logits differ by "
              f"{diff:.4g}, more than twice the plain prefill's "
              f"{diff_plain:.4g}")
        layer_check(cfg, params, record["prompts"])
    else:
        check(diff <= bound * scale,
              f"serve {arch}: prefill vs replay last logits differ by "
              f"{diff:.4g} (max|logit| {scale:.4g}, bound {bound:.4f} of it)")
    prefill_ms = record["prefill_ms"]
    dec_ms = record["decode_ms_per_token"]
    prompts = record["prompts"]
    del record, logits, last, rep, toks
    gc.collect()

    # the same prefill and 8 decode steps again, traced
    model = build_model(cfg)
    prof_kw = dict(activities=[torch.profiler.ProfilerActivity.CUDA],
                   acc_events=True)
    with torch.inference_mode():
        with torch.profiler.profile(**prof_kw) as prof_p:
            model.prefill(params, {"tokens": prompts}, use_kernel=True)
            torch.cuda.synchronize()
        state = model.init_decode_state(b, s + args.gen_len, DEV)
        tok = prompts[:, 0]
        model.decode_step(params, state, tok, max_len=s + args.gen_len)
        with torch.profiler.profile(**prof_kw) as prof_d:
            for _ in range(8):
                _, state = model.decode_step(params, state, tok,
                                             max_len=s + args.gen_len)
            torch.cuda.synchronize()
    in_prefill, busy_p, fam_p, top_p = device_profile(prof_p,
                                                      kernel=trace_name)
    _, busy_d, fam_d, top_d = device_profile(prof_d, kernel=trace_name)
    check(traced_ok(in_prefill, n),
          f"serve {arch}: the prefill's trace holds {len(in_prefill)} "
          f"{trace_name} launches, want {n}")
    print(f"serve {arch}: {n} layers at full width, batch {b}, prompt {s}, "
          f"{args.gen_len} tokens; launches {counts}; prefill "
          f"{prefill_ms:.2f} ms, decode {dec_ms:.3f} ms per token, "
          f"{wall_s:.1f} s in all (replay included); peak memory "
          f"{peak_gb:.2f} GB ({base_gb:.2f} GB allocated before the run) "
          f"[{card_line}]", flush=True)
    print(f"serve {arch} traced: kernel in prefill {len(in_prefill)} "
          f"launches, median {np.median(in_prefill):.4f} ms, sum "
          f"{sum(in_prefill):.3f} ms; prefill device busy {busy_p:.2f} ms, "
          f"idle share {1 - busy_p / prefill_ms:.4f} of the served "
          f"prefill; decode device busy {busy_d / 8:.3f} ms per step, idle "
          f"share {1 - busy_d / 8 / dec_ms:.4f} of the served step",
          flush=True)
    for tag, fam, top in (("prefill", fam_p, top_p), ("decode", fam_d,
                                                      top_d)):
        print(f"serve {arch} {tag} device ms by family: "
              + ", ".join(f"{k} {v:.2f}" for k, v in fam.items()))
        for name, (cnt, ms) in top[:5]:
            print(f"  {ms:10.2f} ms {cnt:6d}x  {name[:110]}")
    out = dict(launches=counts[f"{kernel}.launches"],
               in_prefill_ms=float(np.median(in_prefill)))
    del params, prompts, state, prof_p, prof_d
    gc.collect()
    torch.cuda.empty_cache()
    return out


def layer_check(cfg, params, prompts) -> None:
    """Phase 11, rwkv6: along the served prefill's own activations, each
    layer's time-mix with the scan kernel against the same time-mix with
    the plain per-step recurrence on the same input: y (bf16) within 4
    bf16 ulps of its largest magnitude (4 * 2^-8), the final state (f32)
    within 1e-3 of its largest magnitude."""
    import torch
    from repro_torch.models import rwkv6
    from repro_torch.models.layers import embed_tokens, rms_norm
    from repro_torch.models.transformer import _layer
    worst_y = worst_s = 0.0
    with torch.inference_mode():
        x = embed_tokens(params, prompts).to(torch.bfloat16)
        for layer in range(cfg.n_layers):
            lp = _layer(params, layer)
            h = rms_norm(x, lp["ln1"], cfg.norm_eps)
            y_k, (s_k,), _ = rwkv6.time_mix(cfg, None, [lp["rwkv"]], h,
                                            None, use_kernel=True)
            y_p, (s_p,), _ = rwkv6.time_mix(cfg, None, [lp["rwkv"]], h,
                                            None)
            dy = float((y_k.float() - y_p.float()).abs().max()) \
                / float(y_p.float().abs().max())
            ds = float((s_k - s_p).abs().max()) / float(s_p.abs().max())
            worst_y, worst_s = max(worst_y, dy), max(worst_s, ds)
            x = x + y_k
            h2 = rms_norm(x, lp["ln2"], cfg.norm_eps)
            x = x + rwkv6.channel_mix(cfg, None, [lp["rwkv"]], h2,
                                      None)[0]
    check(worst_y <= 4 * 2.0 ** -8 and worst_s <= 1e-3,
          f"serve {cfg.arch_id}: a layer's time-mix with the kernel differs "
          f"from the plain recurrence by {worst_y:.3g} (y) and {worst_s:.3g}"
          " (state) of their largest magnitudes")
    print(f"serve {cfg.arch_id} layers: time-mix with the kernel against the "
          f"plain recurrence on the prefill's activations, {cfg.n_layers} "
          f"layers: y within {worst_y:.3g}, state within {worst_s:.3g} of "
          "their largest magnitudes", flush=True)


def agree_serve_with_cpu(arch) -> None:
    """Phase 12: reduced float32 serving, card against CPU: tokens equal,
    logits within 1e-4 of their largest magnitude; the card's prefill
    launched the kernel once per layer."""
    import torch
    from repro_torch import tree as tree_lib
    from repro_torch.configs import get_reduced_config
    from repro_torch.launch import serve
    from repro_torch.models import build_model
    cfg = dataclasses.replace(get_reduced_config(arch), dtype="float32")
    params = build_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    prompts = torch.randint(0, cfg.vocab, (4, 32),
                            generator=torch.Generator().manual_seed(1))
    recs = {}
    for dev in (DEV, "cpu"):
        args = serve.parse_args(["--device", dev, "--prompt-len", "32",
                                 "--gen-len", "8"])
        recs[dev] = serve.run(cfg, args,
                              params=tree_lib.tree_map(lambda a: a.to(dev),
                                                       params),
                              prompts=prompts.to(dev))
    kernel = "rwkv6_scan" if cfg.rwkv else "flash_attention"
    check(recs[DEV]["prefill_launches"][kernel] == cfg.n_layers,
          f"sagree {arch}: prefill launches {recs[DEV]['prefill_launches']}")
    check(torch.equal(recs[DEV]["tokens"].cpu(), recs["cpu"]["tokens"]),
          f"sagree {arch}: tokens differ")
    worst = 0.0
    for key in ("prefill_logits", "replay_logits", "step_logits"):
        a, b = recs[DEV][key].cpu(), recs["cpu"][key]
        worst = max(worst, float((a - b).abs().max()) / float(b.abs().max()))
    check(worst <= 1e-4, f"sagree {arch}: logits differ by {worst:.3g} of "
          "their largest magnitude")
    print(f"sagree {arch}: reduced float32 serve, card vs cpu: tokens equal, "
          f"logits within {worst:.3g} of their largest magnitude", flush=True)


def flat_update_check(n, card_line, chunk=1 << 26):
    """Phase (e): the flat ``consensus_update`` on one f32 row of ``n``
    elements. Its own path first: the public ``ops.consensus_update`` once,
    its launch counted from 0. Then the kernel against the plain version
    over block-aligned chunks of the same inputs (theta' and lam' bit for
    bit; r^2 and s^2 within 1e-6 relative), both timed. Returns the
    launches and the numbers."""
    import torch
    from repro_torch.kernels import ops, ref
    dev = torch.device(DEV)
    g = torch.Generator(device=dev).manual_seed(n % 1000)
    vecs = [torch.randn(n, generator=g, device=dev) for _ in range(5)]
    theta, lam, nbr, bar, barp = vecs
    sc = dict(eta_sum=0.7, eta_node=0.35, step_size=0.2, block_size=65536)
    tk, lk = theta.clone(), lam.clone()
    ops.consensus_update.launches = 0
    _, _, rsq, ssq = ops.consensus_update(tk, lk, nbr, bar, barp, **sc)
    torch.cuda.synchronize()
    launches = ops.consensus_update.launches
    check(launches == 1, f"consensus_update launched {launches} times")
    r_sum = torch.zeros((), device=dev)
    s_sum = torch.zeros((), device=dev)
    t_plain = 0.0
    for c0 in range(0, n, chunk):
        sl = slice(c0, min(c0 + chunk, n))
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        tn, ln, r_c, s_c = ref.consensus_update_ref(
            theta[sl], lam[sl], nbr[sl], bar[sl], barp[sl], **sc)
        b.record()
        torch.cuda.synchronize()
        t_plain += a.elapsed_time(b)
        check(torch.equal(tk[sl], tn) and torch.equal(lk[sl], ln),
              f"consensus_update n={n}: theta'/lam' differ from the plain "
              "version")
        r_sum += r_c
        s_sum += s_c
    rel = rs_rel_err((rsq[None], ssq[None]), (r_sum[None], s_sum[None]))
    check(rel < 1e-6, f"consensus_update n={n}: r^2/s^2 relative error "
          f"{rel:.3g}")
    ms = time_cuda(lambda: ops.consensus_update(tk, lk, nbr, bar, barp, **sc),
                   reps=10)
    by = sum(nbytes(t) for t in vecs) + 2 * nbytes(theta)
    bound_ms = by / HBM_BYTES_PER_S * 1e3
    t_ops = n * 14 / F32_OPS_PER_S * 1e3
    by_what = "bytes" if bound_ms >= t_ops else "operations"
    print(f"consensus_update n={n}: launches {launches} max_abs_err=0 "
          f"r2/s2 rel {rel:.3g} kernel {ms:.3f} ms, plain (chunked) "
          f"{t_plain:.3f} ms, bound {max(bound_ms, t_ops):.3f} ms "
          f"({by_what}, {by / 1e9:.3f} GB) [{card_line}]", flush=True)
    del vecs, theta, lam, nbr, bar, barp, tk, lk
    torch.cuda.empty_cache()
    return dict(launches=launches, max_abs_err=0.0, ms=ms, plain_ms=t_plain,
                bound_ms=max(bound_ms, t_ops), bound_by=by_what)


def agree_with_cpu(steps: int = 6) -> None:
    """Reduced qwen3-4b, float32: losses, r_max and eta per round on the
    card equal the CPU run's to rtol 1e-3 (float32 matmul round-off; TF32
    is off)."""
    import torch
    from repro_torch.configs import get_reduced_config
    from repro_torch.core.penalty import PenaltyConfig
    from repro_torch.data import DataConfig, SyntheticTokens
    from repro_torch.models import build_model
    from repro_torch.optim import ConsensusConfig, ConsensusTrainer
    from repro_torch.optim.adamw import AdamWConfig
    cfg = dataclasses.replace(get_reduced_config("qwen3-4b"),
                              dtype="float32")
    model = build_model(cfg)
    params1 = model.init(torch.Generator().manual_seed(0), "cpu")
    traces = {}
    for dev in (DEV, "cpu"):
        tr = ConsensusTrainer(
            model, num_nodes=2, device=dev, adamw=AdamWConfig(lr=1e-2),
            consensus=ConsensusConfig(
                penalty=PenaltyConfig(scheme="nap", eta0=0.1),
                topology="ring", local_steps=2))
        data = SyntheticTokens(DataConfig(vocab=cfg.vocab, seq_len=32,
                                          batch_per_node=4, num_nodes=2),
                               device=dev)
        state = tr.init_state(params1)
        trace = []
        for step in range(steps):
            state, m = tr.train_step(state, data.batch(step))
            trace.append(float(m["loss"]))
            if tr.should_sync(step):
                state, cm = tr.consensus_step(state, data.batch(10**6 + step))
                trace += [float(cm["r_max"]), float(cm["eta_mean"])]
        traces[dev] = np.asarray(trace)
    card, cpu = traces[DEV], traces["cpu"]
    rel = float(np.max(np.abs(card - cpu) / np.abs(cpu)))
    check(bool(np.all(np.isfinite(card))) and rel < 1e-3,
          f"card vs cpu trace: {card.tolist()} vs {cpu.tolist()}")
    print(f"agree: reduced float32 trainer, {steps} steps, card vs cpu "
          f"max relative difference {rel:.3g}", flush=True)


def static_slice(full, card_line, codec):
    """Phases 4 and (c): ``launch.train.run`` on the static slice's
    configuration with the ``codec`` wire, under torch.profiler; every
    round must launch the ungated kernel (with per-block scales for an fp8
    wire) and never the gated one. Returns the launches, the in-round
    kernel times, the wire bytes and the layout."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_lib
    from repro_torch.models import build_model
    from repro_torch.optim import consensus as cons_lib
    cfg = dataclasses.replace(full, n_layers=SLICE_LAYERS)
    args = train_lib.parse_args(SLICE_ARGS + ["--wire-codec", codec])
    tag = "slice" if codec == "native" else f"{codec} slice"
    torch.cuda.reset_peak_memory_stats()
    for c in COUNTS:
        setattr(ops.consensus_round, c, 0)
    # the last round's state, for phase 25 (a reference kept, no work)
    orig_step, last = cons_lib.ConsensusTrainer.consensus_step, []

    def step(self, *a, **kw):
        out = orig_step(self, *a, **kw)
        last[:] = [out[0]]
        return out

    cons_lib.ConsensusTrainer.consensus_step = step
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA],
                acc_events=True) as prof:
            t0 = time.perf_counter()
            record = train_lib.run(cfg, args)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        cons_lib.ConsensusTrainer.consensus_step = orig_step
    launches, masked, per_block = (getattr(ops.consensus_round, c)
                                   for c in COUNTS)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    in_round, busy_ms, families, top = device_profile(prof)
    del prof
    losses, rounds = record["losses"], record["rounds"]
    n_rounds = args.steps // args.local_steps
    fp8 = codec.startswith("fp8")
    check(len(losses) == args.steps and all(map(math.isfinite, losses)),
          f"{tag}: losses {losses}")
    check(len(rounds) == n_rounds, f"{len(rounds)} rounds, want {n_rounds}")
    for r in rounds:
        check(math.isfinite(r["r_max"]) and math.isfinite(r["eta_mean"]),
              f"{tag}: round metrics {r}")
    check(any(abs(r["eta_mean"] - args.eta0) > 1e-6 for r in rounds),
          f"{tag}: nap never moved eta off eta0")
    check(losses[-1] < losses[0], f"{tag}: loss did not fall: {losses}")
    check(launches == n_rounds and masked == 0
          and per_block == (n_rounds if fp8 else 0),
          f"{tag}: {launches} ungated ({per_block} per-block) and {masked} "
          f"gated launches in {n_rounds} rounds")
    check(traced_ok(in_round, n_rounds),
          f"the trace holds {len(in_round)} {KERNEL_NAME} launches, "
          f"want {n_rounds}")
    layout = record["layout"]
    wire_bytes = record["wire_bytes"]
    want_bytes = (layout.total + 4 * layout.num_blocks if fp8
                  else 2 * layout.total)
    check(wire_bytes == want_bytes,
          f"{tag}: {wire_bytes} wire bytes per node per offset, want "
          f"{want_bytes}")
    wire_b = 1 if fp8 else 2
    main_bound = (2 * layout.total * (2 + 4 + 4 + wire_b)
                  + 2 * layout.total * (2 + 4 + 4)) / HBM_BYTES_PER_S * 1e3
    print(f"{tag}: {cfg.arch_id} x{SLICE_LAYERS} layers at full width, "
          f"{build_model(cfg).param_count()} parameters per node, "
          f"{layout.total} elements per node row, {len(rounds)} rounds, "
          f"launches {launches} (per-block {per_block}), wire {wire_bytes} "
          f"bytes per node per offset ({wire_bytes / (2 * layout.total):.4f}"
          f" of the native wire)", flush=True)
    print(f"{tag} step seconds: "
          + " ".join(f"{t:.3f}" for t in record["step_seconds"]), flush=True)
    print(f"{tag} losses: " + " ".join(f"{x:.4f}" for x in losses))
    print(f"{tag} rounds: " + json.dumps(rounds), flush=True)
    print(f"{tag} kernel in rounds: median {np.median(in_round):.3f} ms "
          f"(each {', '.join(f'{t:.3f}' for t in in_round)}), "
          f"bound {main_bound:.3f} ms; peak memory {peak_gb:.2f} GB "
          f"[{card_line}]", flush=True)
    print(f"{tag} trace: host {wall_ms:.1f} ms, device busy {busy_ms:.1f} "
          f"ms, idle share {1 - busy_ms / wall_ms:.4f}; device ms by family: "
          + ", ".join(f"{k} {v:.1f}" for k, v in families.items()),
          flush=True)
    for name, (n, ms) in top:
        print(f"  {ms:10.1f} ms {n:6d}x  {name[:110]}")
    nodes, replicated = state_digests(last.pop(), 0)
    del record
    torch.cuda.empty_cache()
    return dict(launches=launches, per_block=per_block,
                in_round_ms=float(np.median(in_round)), layout=layout,
                nodes=nodes, replicated=replicated, rounds=rounds)


# -- the ranks slice: the trainer over torch.distributed -------------------
RANKS_ARGS = ["--nodes", "3", "--scheme", "nap", "--topology", "ring",
              "--eta0", "0.1", "--topo-scheduler", "budget", "--drop-node",
              "2:1", "--local-steps", "1", "--steps", "4",
              "--batch-per-node", "4", "--seq", "512", "--lr", "3e-4",
              "--device", DEV]
RANKS_LAYERS = 1
RANKS_PROCS = 3
RANKS_TIMEOUT_S = 480           # one torchrun call, start to end
# phase 26: the sharded consensus state, J 2 x S 2 gloo ranks on the card
SHARD_ARCH = "stablelm-3b"
SHARD_LAYERS = 1                # for the script's time
SHARD_NODES, SHARD_S = 2, 2
SHARD_ARGS = ["--arch", SHARD_ARCH, "--nodes", str(SHARD_NODES), "--scheme",
              "nap", "--topology", "ring", "--eta0", "0.1", "--local-steps",
              "2", "--steps", "4", "--batch-per-node", "4", "--seq", "512",
              "--lr", "3e-4", "--shard-consensus", "--device", DEV]
# phase 26's runs (tag: codec, extra arguments); 26b is the async one
ASYNC_EXTRA = ["--async", "--max-staleness", "1", "--slow-node", "0:4.0",
               "--local-steps", "1"]
SHARD_RUNS = {"native": ("native", []), "fp8_e4m3": ("fp8_e4m3", []),
              "async fp8_e4m3": ("fp8_e4m3", ASYNC_EXTRA)}
# phase 27: the round pipeline and the async executor across ranks, J 3 on
# a ring (offsets 1, 2), three gloo ranks sharing the card, a node a rank
PIPE_ARCH = "stablelm-3b"
PIPE_LAYERS = 1                 # for the script's time
PIPE_NODES = 3
PIPE_DEPTH = 2
PIPE_ARGS = ["--arch", PIPE_ARCH, "--nodes", str(PIPE_NODES), "--scheme",
             "nap", "--topology", "ring", "--eta0", "0.1",
             "--batch-per-node", "4", "--seq", "512", "--lr", "3e-4",
             "--device", DEV]
PIPE_RUNS = {"sync native": ["--wire-codec", "native", "--local-steps", "2",
                             "--steps", "4"],
             "async fp8_e4m3": ["--wire-codec", "fp8_e4m3", "--steps", "6"]
             + ASYNC_EXTRA}


# phase 28: expert-parallel serving of moonshot-v1-16b-a3b, 12 of 48 layers
# (for time), data 1 x model 2 gloo ranks sharing the card
EP_ARCH = "moonshot-v1-16b-a3b"
EP_LAYERS = 12
EP_MESH = (1, 2)
EP_BATCH, EP_PROMPT, EP_DECODE = 4, 512, 16
EP_SEED = 28
EP_CHECK_CF = 2.0             # capacity factor at which ep 2 drops nothing
# how much further the EP decode may sit from the served (flash kernel)
# prefill than the witness without a mesh does: the two take other routes
# at near-tied gates, so their gaps differ by chance (on an H100 at this
# seed: max |diff| 3.82 against 4.09, top-1 0.328 against 0.328)
EP_SERVED_DIFF_RATIO, EP_SERVED_TOP1_MARGIN = 1.25, 0.1


def digest_parts(t, offset=0, chunk=1 << 24) -> tuple[int, int, int]:
    """The digest of a tensor's bytes as sums, computed on its device: the
    element count, the sum of its bytes read as integers of its element
    size, and a position-weighted sum (positions from ``offset``), wrapping
    in int64. Integer sums do not depend on the order of their terms, so
    the parts of a row's slabs, each at its offset, add up to the row's
    (``join_digest``). Not cryptographic."""
    import torch
    flat = t.reshape(-1)
    ints = flat.view({1: torch.uint8, 2: torch.int16, 4: torch.int32,
                      8: torch.int64}[flat.element_size()])
    s1 = s2 = 0
    for c0 in range(0, ints.numel(), chunk):
        x = ints[c0:c0 + chunk].to(torch.int64)
        w = torch.arange(offset + c0, offset + c0 + x.numel(),
                         dtype=torch.int64, device=x.device) % 65521 + 1
        s1 += int(x.sum())
        s2 = (s2 + int((x * w).sum())) % (1 << 64)
    return ints.numel(), s1, s2


def join_digest(parts) -> str:
    """The digest string of a row from the ``digest_parts`` of its slabs."""
    parts = list(parts)
    return (f"{sum(p[0] for p in parts)}:{sum(p[1] for p in parts)}:"
            f"{sum(p[2] for p in parts) % (1 << 64)}")


def digest(t, chunk=1 << 24) -> str:
    """A digest of a tensor's bytes (``digest_parts``, as a string)."""
    return join_digest([digest_parts(t, chunk=chunk)])


def state_digests(state, node_lo):
    """({node id: digests of its parameter rows, lam and theta_bar_prev
    rows and, with a wire ledger, its ledger rows}, the replicated eta,
    mask and liveness, and the ledger's w_prev and round) of a trainer
    state holding nodes ``node_lo``... ."""
    from repro_torch import tree as tree_lib
    leaves = tree_lib.leaves(state.params)
    nodes = {str(node_lo + i): {
        "params": [digest(x[i]) for x in leaves],
        "lam": digest(state.lam[i]), "bar": digest(state.theta_bar_prev[i])}
        for i in range(state.lam.shape[0])}
    rep = {"eta": digest(state.penalty.eta), "mask": digest(state.topo.mask),
           "alive": state.topo.node_alive.tolist()}
    if state.ledger is not None:
        for i in range(state.lam.shape[0]):
            nodes[str(node_lo + i)]["ledger"] = digest(
                state.ledger.wires[:, i].contiguous())
        rep.update(w_prev=digest(state.ledger.w_prev),
                   ledger_round=int(state.ledger.round))
    return nodes, rep


def ledger_slab_parts(ledger, shard):
    """A slab rank's ledger rows ``[deg, 1, w]`` as ``digest_parts`` at
    their places in its node's whole ledger rows ``[deg, S * w]``, so that
    the S slabs' parts join into the whole rows' digest."""
    deg, _, w = ledger.wires.shape
    return [digest_parts(ledger.wires[d, 0], d * SHARD_S * w + shard * w)
            for d in range(deg)]


def traced_train(cfg, args, grid=None, extra=None):
    """``launch.train.run`` with hooks: the last round's state, each round
    kernel's device ms (CUDA events) and host interval (``time.time``,
    synchronized, comparable across processes), and each round's seconds
    in the exchange (``circulant_start``'s issue and the host time blocked
    in ``Pending.wait``, neither synchronized: what the round exposes).
    Counters from 0. ``grid``: a caller's ``RankGrid`` for the run.
    ``extra`` (a dict), if given, receives each round's seconds in the
    in-pod gathers (``gather_s``), in the exchange's issue (``issue_s``)
    and exposed wait (``wait_s``), in the neighbour probes (``probe_s``,
    synchronized at each probe's end), the trainer's pinned staging bytes
    (``staging_bytes``), and the digests of the parameter leaves after
    every local step and every round (``params``). Returns (record, state,
    kernel ms, intervals, exchange seconds per round)."""
    import torch
    from repro_torch import tree as tree_lib
    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_lib
    from repro_torch.optim import consensus as cons_lib
    Trainer = cons_lib.ConsensusTrainer
    orig_steps = {n: getattr(Trainer, n)
                  for n in ("consensus_step", "consensus_step_async")}
    orig_train = Trainer.train_step
    orig_probe = Trainer._probe_row
    orig_launch = ops._cu.launch
    orig_start = cons_lib.circulant_start
    orig_gather = cons_lib.gather_pod
    last, ms, spans, ex, issue, wait_s, probe_s = [], [], [], [], [], [], []
    depth = [0]
    if extra is not None:
        extra.update(gather_s=[], params=[], issue_s=issue, wait_s=wait_s,
                     probe_s=probe_s, staging_bytes=0)

    def params_digests(state):
        if extra is not None:
            extra["params"].append([digest(x)
                                    for x in tree_lib.leaves(state.params)])

    def hooked(name):
        orig = orig_steps[name]

        def step(self, *a, **kw):
            depth[0] += 1
            if depth[0] == 1:      # an async round at bound 0 is the sync one
                for xs in (ex, issue, wait_s, probe_s):
                    xs.append(0.0)
                if extra is not None:
                    extra["gather_s"].append(0.0)
            try:
                out = orig(self, *a, **kw)
            finally:
                depth[0] -= 1
            if depth[0] == 0:
                ex[-1] = issue[-1] + wait_s[-1]
                last[:] = [out[0]]
                params_digests(out[0])
                if extra is not None:
                    extra["staging_bytes"] = self.staging_bytes()
            return out
        return step

    def start(*a, **kw):
        t0 = time.perf_counter()
        pend = orig_start(*a, **kw)
        issue[-1] += time.perf_counter() - t0
        orig_wait = pend.wait

        def wait():
            t1 = time.perf_counter()
            orig_wait()
            wait_s[-1] += time.perf_counter() - t1
        pend.wait = wait
        return pend

    def probe(self, *a, **kw):
        t0 = time.perf_counter()
        out = orig_probe(self, *a, **kw)
        torch.cuda.synchronize()
        probe_s[-1] += time.perf_counter() - t0
        return out

    def train(self, *a, **kw):
        out = orig_train(self, *a, **kw)
        params_digests(out[0])
        return out

    def gather(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig_gather(*a, **kw)
        torch.cuda.synchronize()
        extra["gather_s"][-1] += time.perf_counter() - t0
        return out

    def launch(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.time()
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        ev0.record()
        out = orig_launch(*a, **kw)
        ev1.record()
        ev1.synchronize()
        spans.append((t0, time.time()))
        ms.append(ev0.elapsed_time(ev1))
        return out

    for c in COUNTS:
        setattr(ops.consensus_round, c, 0)
    for name in orig_steps:
        setattr(Trainer, name, hooked(name))
    ops._cu.launch = launch
    cons_lib.circulant_start = start
    Trainer._probe_row = probe
    if extra is not None:
        Trainer.train_step = train
        cons_lib.gather_pod = gather
    try:
        record = train_lib.run(cfg, args, grid)
    finally:
        for name, fn in orig_steps.items():
            setattr(Trainer, name, fn)
        Trainer.train_step = orig_train
        Trainer._probe_row = orig_probe
        ops._cu.launch = orig_launch
        cons_lib.circulant_start = orig_start
        cons_lib.gather_pod = orig_gather
    torch.cuda.synchronize()
    record["counts"] = {c: getattr(ops.consensus_round, c) for c in COUNTS}
    return record, last[0], ms, spans, ex


def ranks_worker(spec_path) -> int:
    """One rank of a torchrun call (``chip_smoke.py --ranks-worker
    SPEC``): each part of the spec's chain in turn (``rank_part``), its
    results under ``part<i>/``; then this rank's seconds in each part into
    ``seconds<r>.json``. The parts share one process group (each grid's
    ``close`` waits for the chain's end: a group made again would find the
    first one's addresses in torchrun's store); between parts the device's
    and the host's cached blocks are let go."""
    import torch
    import torch.distributed as dist
    from repro_torch.distributed import grid as grid_lib
    from repro_torch.distributed.exchange import empty_host_cache
    with open(spec_path) as f:
        chain = json.load(f)["chain"]
    rank = int(os.environ["RANK"])
    top = os.path.dirname(spec_path)
    seconds = []
    close = grid_lib.RankGrid.close
    grid_lib.RankGrid.close = lambda self: None
    try:
        for n, part in enumerate(chain):
            t0 = time.perf_counter()
            out_dir = os.path.join(top, f"part{n}")
            os.makedirs(out_dir, exist_ok=True)
            rc = rank_part(part, rank, out_dir)
            if rc:
                return rc
            gc.collect()
            torch.cuda.empty_cache()
            empty_host_cache()
            seconds.append(time.perf_counter() - t0)
    finally:
        grid_lib.RankGrid.close = close
        if dist.is_initialized():
            dist.destroy_process_group()
    with open(os.path.join(top, f"seconds{rank}.json"), "w") as f:
        json.dump(seconds, f)
    return 0


def rank_part(spec, rank, out_dir) -> int:
    """One part of a rank's chain: ``traced_train`` on the spec's
    arguments and depth (or the phase's own worker), then this rank's
    digests and numbers into ``out_dir/rank<r>.json``."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import train as train_lib
    cfg = dataclasses.replace(get_config(spec.get("arch", "qwen3-4b")),
                              n_layers=spec["layers"])
    if "runs" in spec:
        return runs_worker(spec, cfg, rank, out_dir)
    if spec.get("ep"):
        return ep_worker(spec, cfg, rank, out_dir)
    if spec.get("inpod"):
        return inpod_worker(spec, cfg, rank, out_dir)
    if spec.get("rep"):
        return rep_worker(spec, cfg, rank, out_dir)
    if spec.get("tp"):
        return tp_worker(spec, cfg, rank, out_dir)
    args = train_lib.parse_args(spec["args"])
    torch.cuda.reset_peak_memory_stats()
    record, state, ms, spans, ex = traced_train(cfg, args)
    per = args.nodes // int(os.environ["WORLD_SIZE"])
    nodes, rep = state_digests(state, rank * per)
    out = dict(rank=rank, nodes=nodes, replicated=rep,
               rounds=record["rounds"], step_seconds=record["step_seconds"],
               kernel_ms=ms, spans=spans, exchange_s=ex,
               counts=record["counts"], wire_bytes=record["wire_bytes"],
               total=record["layout"].total,
               device=str(state.lam.device),
               peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               reserved_gb=torch.cuda.max_memory_reserved() / 1e9)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    return 0


def launch_ranks(tag, nproc, args_list, layers, **more):
    """One part alone in a torchrun call (``launch_chain``): ``more`` goes
    into the workers' spec beside the arguments and the depth. Returns the
    ranks' records and the call's seconds."""
    ranks, seconds, _ = launch_chain(tag, nproc, [(args_list, layers, more)])
    return ranks[0], seconds


def launch_chain(tag, nproc, parts, timeout=RANKS_TIMEOUT_S):
    """``chip_smoke.py --ranks-worker`` under ``torchrun --standalone
    --nproc-per-node nproc`` (its own process group, killed whole at
    ``timeout``): each rank runs the ``parts`` ((arguments, depth, more)
    each) in turn, so that the call's start and each rank process's first
    warm step are paid once for all of them; fails unless every rank ends
    with 0. Returns each part's ranks' records, the call's seconds and
    rank 0's seconds in each part."""
    import signal
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        spec = os.path.join(tmp, "spec.json")
        with open(spec, "w") as f:
            json.dump({"chain": [{"args": a, "layers": n, **m}
                                 for a, n, m in parts]}, f)
        env = dict(os.environ)
        # one host: the ranks' sockets stay on the loopback interface
        env.setdefault("GLOO_SOCKET_IFNAME", "lo")
        env.setdefault("NCCL_SOCKET_IFNAME", "lo")
        # ranks sharing a card: each process's allocator maps and unmaps
        # pages instead of keeping segments of its own phases' sizes
        env.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
        log = os.path.join(tmp, "torchrun.log")
        t0 = time.perf_counter()
        with open(log, "w") as out:
            proc = subprocess.Popen(
                [sys.executable, "-m", "torch.distributed.run",
                 "--standalone", "--nproc-per-node", str(nproc),
                 os.path.join(ROOT, "chip_smoke.py"), "--ranks-worker",
                 spec], stdout=out, stderr=subprocess.STDOUT, env=env,
                start_new_session=True)
            try:
                rc = proc.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                rc = f"none: killed at its {timeout} s limit"
            finally:
                # the agent and its ranks: nothing outlives the call
                try:
                    os.killpg(proc.pid, signal.SIGKILL)
                except ProcessLookupError:
                    pass
                proc.wait()
        seconds = time.perf_counter() - t0
        with open(log) as f:
            text = f.read()
        lines = [ln for ln in text.splitlines() if "consensus r=" in ln]
        print(f"{tag}: torchrun --nproc-per-node {nproc}, rc {rc}, "
              f"{seconds:.1f} s; rank 0's last lines:\n  "
              + "\n  ".join(lines[-3:]), flush=True)
        if rc != 0:        # every rank's traceback, then the agent's tail
            print("\n".join(ln for ln in text.splitlines()
                            if ln.startswith("[rank"))[-12000:], flush=True)
        check(rc == 0, f"{tag}: torchrun exited {rc}:\n{text[-3000:]}")
        ranks = []
        for n in range(len(parts)):
            ranks.append([])
            for r in range(nproc):
                with open(os.path.join(tmp, f"part{n}", f"rank{r}.json")) as f:
                    ranks[-1].append(json.load(f))
        with open(os.path.join(tmp, "seconds0.json")) as f:
            part_s = json.load(f)
    return ranks, seconds, part_s


def together(tag, slices, chain=None):
    """Phases whose ranks share one torchrun call. Each of ``slices`` (a
    generator) runs its one-process part up to the ranks it asks for,
    ``(tag, nproc, arguments, depth, more)``, all of one world size; the
    ranks run every request in turn (in the order ``chain`` gives, by
    index), and each slice gets its ranks' records and its part's seconds
    on rank 0 and runs on to its end; a further request of a slice is
    launched alone. Returns the slices' results."""
    reqs = [next(g) for g in slices]
    nproc = {r[1] for r in reqs}
    check(len(nproc) == 1, f"{tag}: world sizes {nproc} in one call")
    order = list(chain or range(len(slices)))
    ranks, seconds, part_s = launch_chain(
        tag, nproc.pop(), [reqs[i][2:] for i in order],
        timeout=RANKS_TIMEOUT_S)
    print(f"{tag}: one torchrun call of {seconds:.1f} s; rank 0's seconds "
          "in each part: " + ", ".join(f"{reqs[i][0]} {t:.1f}"
                                        for i, t in zip(order, part_s)),
          flush=True)
    got = {i: (ranks[n], part_s[n]) for n, i in enumerate(order)}
    out = []
    for i, g in enumerate(slices):
        reply = got[i]
        while True:
            try:
                req = g.send(reply)
            except StopIteration as stop:
                out.append(stop.value)
                break
            reply = launch_ranks(req[0], req[1], req[2], req[3], **req[4])
    return out


def same_run(tag, ranks, nodes, rep, rounds):
    """Each rank's node digests and replicated digests equal the
    one-process run's (``nodes``, ``rep``), and its rounds' metrics equal
    ``rounds``, bit for bit."""
    got = {}
    for r in ranks:
        got.update(r["nodes"])
        check(r["replicated"] == rep,
              f"{tag}: rank {r['rank']}'s replicated state "
              f"{r['replicated']} != {rep}")
        check(len(r["rounds"]) == len(rounds),
              f"{tag}: rank {r['rank']} ran {len(r['rounds'])} rounds, "
              f"want {len(rounds)}")
        for a, b in zip(r["rounds"], rounds):
            keys = [k for k in b if k not in ("seconds",) + COUNTS]
            check(all(a[k] == b[k] for k in keys),
                  f"{tag}: rank {r['rank']}'s round "
                  f"{ {k: a[k] for k in keys} } != { {k: b[k] for k in keys} }")
    check(got == nodes, f"{tag}: node rows differ: "
          + str([n for n in nodes if got.get(n) != nodes[n]]))


def ranks_slice(full, card_line):
    """Phase 24: three ranks share the card over gloo against one process,
    on qwen3-4b at full width, one layer (``RANKS_ARGS``)."""
    import torch
    from repro_torch.launch import train as train_lib
    cfg = dataclasses.replace(full, n_layers=RANKS_LAYERS)
    args = train_lib.parse_args(RANKS_ARGS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    record, state, ms1, _, ex1 = traced_train(cfg, args)
    one_s = time.perf_counter() - t0
    peak1 = torch.cuda.max_memory_allocated() / 1e9
    nodes, rep = state_digests(state, 0)
    del state
    torch.cuda.empty_cache()
    free, card_bytes = torch.cuda.mem_get_info()
    print(f"ranks: {free / 1e9:.2f} of {card_bytes / 1e9:.2f} GB free "
          "before the ranks start", flush=True)
    n_rounds = args.steps // args.local_steps
    check(record["counts"] == {"launches": 0, "masked_launches": n_rounds,
                               "per_block_launches": 0},
          f"ranks one process: launches {record['counts']}")
    ranks, call_s = yield ("phase 24", RANKS_PROCS,
                           RANKS_ARGS + ["--dist-backend", "gloo"],
                           RANKS_LAYERS, {})
    same_run("ranks", ranks, nodes, rep, record["rounds"])
    for r in ranks:
        check(r["counts"] == {"launches": 0, "masked_launches": n_rounds,
                              "per_block_launches": 0}
              and len(r["kernel_ms"]) == n_rounds,
              f"ranks: rank {r['rank']} launches {r['counts']}")
        check(r["wire_bytes"] == record["wire_bytes"],
              f"ranks: wire bytes {r['wire_bytes']}")
    total, deg = ranks[0]["total"], len(record["offsets"])
    # one node's row: theta and the wires bf16, lam, bar_prev, lam', bar
    # f32, theta' bf16
    bound = total * (2 + 2 + 4 + 4 + 4 + 4 + 2 * deg) / HBM_BYTES_PER_S * 1e3
    overlap = sum(
        max(r["spans"][k][0] for r in ranks)
        < min(r["spans"][k][1] for r in ranks) for k in range(n_rounds))
    print(f"ranks: {cfg.arch_id} x{RANKS_LAYERS} layer at full width, "
          f"{total} elements per node row, J {args.nodes} on "
          f"{RANKS_PROCS} ranks over gloo sharing the card; state, rounds "
          f"and liveness equal the one-process run bit for bit; "
          f"{record['wire_bytes']} wire bytes per node per offset; one "
          f"process {one_s:.1f} s, torchrun {call_s:.1f} s [{card_line}]",
          flush=True)
    for r in ranks:
        print(f"ranks rank {r['rank']} ({r['device']}): peak "
              f"{r['peak_gb']:.2f} GB ({r['reserved_gb']:.2f} reserved); "
              "kernel ms per round "
              + " ".join(f"{t:.3f}" for t in r["kernel_ms"])
              + f" (bound {bound:.3f} at J/R 1); exchange s per round "
              + " ".join(f"{t:.3f}" for t in r["exchange_s"])
              + "; step s " + " ".join(f"{t:.3f}"
                                       for t in r["step_seconds"])
              + f"; step median {np.median(r['step_seconds']):.3f}, round "
              f"median {np.median([x['seconds'] for x in r['rounds']]):.3f}",
              flush=True)
    print(f"ranks one process: peak {peak1:.2f} GB; kernel ms per round "
          + " ".join(f"{t:.3f}" for t in ms1)
          + f" (bound {bound * args.nodes:.3f} at J 3); local copies s per "
          "round " + " ".join(f"{t:.3f}" for t in ex1)
          + f"; step median {np.median(record['step_seconds']):.3f}, round "
          f"median {np.median([x['seconds'] for x in record['rounds']]):.3f}"
          f"; the ranks' kernels overlapped in {overlap} of {n_rounds} "
          f"rounds [{card_line}]", flush=True)
    return dict(launches=sum(r["counts"]["masked_launches"] for r in ranks),
                kernel_ms=float(np.median([t for r in ranks
                                           for t in r["kernel_ms"]])),
                bound_ms=bound,
                exchange_s=float(np.median([t for r in ranks
                                            for t in r["exchange_s"]])),
                overlap_rounds=overlap, seconds=one_s + call_s)


def runs_worker(spec, cfg, rank, out_dir) -> int:
    """One rank of a torchrun call of several runs (phases 26, 26b and 27):
    one grid (``init_ranks``, gloo on the card; sharded in-pod with
    ``spec["shard"]``) for every run of ``spec["runs"]``, each traced
    (``traced_train``); this rank's digests and numbers into
    ``rank<r>.json``. A slab rank's digests: its node's parameters whole
    after every step, its lam, theta_bar_prev and ledger slabs as parts at
    their offsets; a rank of nodes': ``state_digests``."""
    import torch
    from repro_torch.launch import train as train_lib
    from repro_torch.launch.mesh import init_ranks
    from repro_torch import tree as tree_lib
    first = train_lib.parse_args(spec["runs"][0])
    sharded = bool(spec.get("shard"))
    grid = init_ranks(first.nodes, first.device, backend="gloo",
                      shard_consensus=sharded)
    runs = []
    try:
        for args_list in spec["runs"]:
            args = train_lib.parse_args(args_list)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            extra = {}
            record, state, ms, spans, ex = traced_train(cfg, args, grid,
                                                        extra)
            lay = record["layout"]
            run = dict(
                rank=rank, replicated=state_digests(state, grid.pod)[1],
                rounds=record["rounds"], step_seconds=record["step_seconds"],
                kernel_ms=ms, spans=spans, exchange_s=ex,
                issue_s=extra["issue_s"], wait_s=extra["wait_s"],
                probe_s=extra["probe_s"],
                staging_bytes=extra["staging_bytes"],
                gather_s=extra["gather_s"], counts=record["counts"],
                wire_bytes=record["wire_bytes"], total=lay.total,
                block_size=lay.block_size, device=str(state.lam.device),
                peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                reserved_gb=torch.cuda.max_memory_reserved() / 1e9,
                state_gb=torch.cuda.memory_allocated() / 1e9)
            if sharded:
                off = grid.shard * state.lam.shape[1]
                run.update(
                    pod=grid.pod, shard=grid.shard,
                    params=[digest(x) for x in tree_lib.leaves(state.params)],
                    step_params=extra["params"],
                    lam=digest_parts(state.lam[0], off),
                    bar=digest_parts(state.theta_bar_prev[0], off),
                    lam_shape=list(state.lam.shape),
                    ledger=(None if state.ledger is None else
                            ledger_slab_parts(state.ledger, grid.shard)),
                    ledger_shape=(None if state.ledger is None
                                  else list(state.ledger.wires.shape)))
            else:
                run["nodes"] = state_digests(state, grid.node_lo)[0]
            runs.append(run)
            del state, record, extra
            gc.collect()
            run["left_gb"] = torch.cuda.memory_allocated() / 1e9
    finally:
        grid.close()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump({"rank": rank, "runs": runs}, f)
    return 0


def reckon_sharded_peak(cfg, params, total, deg, codec,
                        ledger=False) -> dict:
    """Phase 26's peak device bytes a rank, reckoned from the code before
    the run: resident, the bf16 parameters and the f32 AdamW moments (10 B
    a parameter) and the f32 lam and theta_bar_prev slabs (8 B an element
    of [1, total / S]); on top, the larger of the local step's transients
    (bf16 gradients, 2 B a parameter, and the activations: three f32
    [B, T, vocab] logit-sized tensors and about 10 d + 3 ffn bf16 values a
    token a layer) and the round's (the packed row, 2 B an element; the
    received slabs; the probe's gathered payload, 2 B an element native or
    1 B fp8, whose dequantized leaves take 2 B a parameter more; or the
    gathered new parameters, 2 B an element). With the async ``ledger``,
    its slab rows are resident and the received slabs land in them."""
    st = total // SHARD_S
    resident = 10 * params + 8 * st
    local = 2 * params + activation_bytes(cfg)
    wire_b = 2 if codec == "native" else 1
    probe = wire_b * total + (0 if codec == "native" else 2 * params)
    received = deg * wire_b * st
    if ledger:
        resident += received
    rnd = 2 * total + (0 if ledger else received) + max(probe, 2 * total)
    return dict(resident=resident, local=local, round=rnd,
                peak=resident + max(local, rnd))


def activation_bytes(cfg, tokens=4 * 512) -> int:
    """A local step's activations, reckoned: three f32 [B, T, vocab]
    logit-sized tensors and about 10 d + 3 ffn bf16 values a token a
    layer."""
    return 3 * tokens * cfg.vocab * 4 \
        + cfg.n_layers * tokens * (10 * cfg.d_model + 3 * cfg.d_ff) * 2


def reckon_pipe_peak(cfg, params, total, deg, codec, ledger) -> dict:
    """Phase 27's peak device bytes a rank (one node's whole rows),
    reckoned from the code: resident, the bf16 parameters and f32 moments
    (10 B a parameter), the f32 lam and theta_bar_prev rows (8 B an
    element) and, async, the ledger's deg rows (2 B an element native, 1 B
    fp8); on top, the larger of the local step's transients
    (``reckon_sharded_peak``) and the round's, which holds the packed row
    (2 B an element) and the received rows (sync: deg x the wire; async
    they land in the ledger, through host memory), and then at its
    largest either the probes' (the fp8 wire, 1 B, and one probe's
    dequantized leaves, 2 B a parameter; native payloads are views) or the
    kernel's inputs (fp8: the stacked decode's contiguous payloads, deg x
    1 B; async: the held copies of a frozen node's lam and theta_bar_prev
    rows, 8 B). The staged pool is pinned host memory, not the card's."""
    wire_b = 2 if codec == "native" else 1
    fp8 = codec != "native"
    resident = 10 * params + 8 * total + (deg * wire_b * total if ledger
                                          else 0)
    local = 2 * params + activation_bytes(cfg)
    base = 2 * total + (0 if ledger else deg * wire_b * total)
    probes = (total + 2 * params) if fp8 else 0
    kernel = (deg * total if fp8 else 0) + (8 * total if ledger else 0)
    rnd = base + max(probes, kernel)
    return dict(resident=resident, local=local, round=rnd,
                peak=resident + max(local, rnd))


def one_process_runs(cfg, runs, grid_of):
    """Each run's arguments (tag -> list) traced in this process on the
    grid ``grid_of()``; per tag its record, digests, kernel ms, seconds
    and peak. The state is freed after each."""
    import torch
    from repro_torch.launch import train as train_lib
    ones = {}
    for tag, args_list in runs.items():
        args = train_lib.parse_args(args_list)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        record, state, ms1, _, _ = traced_train(cfg, args, grid_of())
        nodes, rep = state_digests(state, 0)
        ones[tag] = dict(record=record, nodes=nodes, rep=rep, ms=ms1,
                         seconds=time.perf_counter() - t0,
                         peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        del state
    gc.collect()
    torch.cuda.empty_cache()
    free, card = torch.cuda.mem_get_info()
    print(f"{', '.join(runs)}: one process done; "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB still allocated, "
          f"{free / 1e9:.2f} of {card / 1e9:.2f} GB free", flush=True)
    return ones


def want_counts(n_rounds, codec, async_) -> dict:
    """The round wrapper's launch counts of a run: one ungated launch a
    round (synchronous) or one gated one (async), per-block with fp8."""
    return {"launches": 0 if async_ else n_rounds,
            "masked_launches": n_rounds if async_ else 0,
            "per_block_launches": 0 if codec == "native" else n_rounds}


def row_bound_ms(row, deg, codec, block_size) -> float:
    """The round kernel's least time on a rank's row of ``row`` elements:
    theta and theta' bf16, lam, lam', bar_prev and bar f32, the wires (2 B
    native, 1 B fp8 with 4 B a block) read once, over the HBM rate."""
    wire_b = 2 * deg if codec == "native" else deg
    nbytes = row * (2 + 2 + 4 + 4 + 4 + 4 + wire_b) + (
        0 if codec == "native" else 4 * deg * row // block_size)
    return nbytes / HBM_BYTES_PER_S * 1e3


def same_rounds(tag, r, rec):
    """A rank's rounds' metrics equal the one-process run's, bit for
    bit."""
    check(len(r["rounds"]) == len(rec["rounds"]) and all(
        a[k] == b[k] for a, b in zip(r["rounds"], rec["rounds"])
        for k in b if k not in ("seconds",) + COUNTS),
        f"{tag}: rank {r['rank']}'s rounds differ")


def sharded_slice(card_line):
    """Phases 26 and 26b: ``SHARD_ARGS`` on each run of ``SHARD_RUNS``
    (native and fp8_e4m3 synchronous rounds; fp8_e4m3 async rounds with
    node 0 4x slow, the sharded wire ledger), as one process computing the
    S-way sharded run whole (``trivial_grid(J, shards=S)``) and then, in
    one torchrun call, as J x S gloo ranks sharing the card, each holding
    its node's parameters whole and one slab of its flat rows (and of its
    ledger rows); bit for bit."""
    from repro_torch import resolve_device
    from repro_torch.distributed import trivial_grid
    from repro_torch.models import build_model
    cfg = zoo_config(SHARD_ARCH, SHARD_LAYERS)
    params = build_model(cfg).param_count()
    procs = SHARD_NODES * SHARD_S
    runs = {tag: SHARD_ARGS + ["--wire-codec", codec] + extra
            for tag, (codec, extra) in SHARD_RUNS.items()}
    ones = one_process_runs(cfg, runs, lambda: trivial_grid(
        SHARD_NODES, resolve_device(DEV), shards=SHARD_S))
    lay = ones["native"]["record"]["layout"]
    total, deg = lay.total, len(ones["native"]["record"]["offsets"])
    st = total // SHARD_S
    reckoned = {tag: reckon_sharded_peak(cfg, params, total, deg, codec,
                                         ledger=bool(extra))
                for tag, (codec, extra) in SHARD_RUNS.items()}
    print(f"sharded: {SHARD_ARCH} x{SHARD_LAYERS} layers at full width, "
          f"{params} parameters a node, {total} elements a node row, "
          f"{st} a slab; reckoned peak a rank "
          + ", ".join(f"{c} {r['peak'] / 1e9:.2f} GB (resident "
                      f"{r['resident'] / 1e9:.2f}, local step "
                      f"{r['local'] / 1e9:.2f}, round {r['round'] / 1e9:.2f})"
                      for c, r in reckoned.items()), flush=True)
    ranks, call_s = yield (
        "phase 26", procs, None, SHARD_LAYERS, dict(
            arch=SHARD_ARCH, shard=True,
            runs=[a + ["--dist-backend", "gloo"] for a in runs.values()]))
    out = {}
    for n, (tag_, (codec, extra)) in enumerate(SHARD_RUNS.items()):
        one = ones[tag_]
        rec = one["record"]
        mine = [r["runs"][n] for r in ranks]
        n_rounds = len(rec["rounds"])
        async_ = bool(extra)
        want = want_counts(n_rounds, codec, async_)
        check(rec["counts"] == want,
              f"sharded {tag_} one process: launches {rec['counts']}")
        tag = f"sharded {tag_}"
        got_nodes = {}
        for r in mine:
            check(r["pod"] == r["rank"] // SHARD_S
                  and r["shard"] == r["rank"] % SHARD_S,
                  f"{tag}: rank {r['rank']} holds pod {r['pod']} slab "
                  f"{r['shard']}")
            check(r["lam_shape"] == [1, st],
                  f"{tag}: rank {r['rank']}'s lam {r['lam_shape']}, want "
                  f"[1, {st}]")
            check(r["counts"] == want and len(r["kernel_ms"]) == n_rounds,
                  f"{tag}: rank {r['rank']} launches {r['counts']}")
            check(r["wire_bytes"] == rec["wire_bytes"]
                  and r["total"] == total,
                  f"{tag}: rank {r['rank']} wire bytes {r['wire_bytes']}, "
                  f"total {r['total']}")
            check(r["replicated"] == one["rep"],
                  f"{tag}: rank {r['rank']}'s replicated state")
            same_rounds(tag, r, rec)
            node = got_nodes.setdefault(str(r["pod"]), {
                "lam": [], "bar": [], "ledger": []})
            node["params"] = r["params"]
            for k in ("lam", "bar"):
                node[k].append(r[k])
            if async_:
                check(r["ledger_shape"][1] == 1,
                      f"{tag}: rank {r['rank']}'s ledger "
                      f"{r['ledger_shape']}")
                node["ledger"] += r["ledger"]
        for p in range(SHARD_NODES):
            pod = [r for r in mine if r["pod"] == p]
            check(all(r["step_params"] == pod[0]["step_params"]
                      and r["params"] == pod[0]["params"] for r in pod)
                  and len(pod[0]["step_params"]) == len(
                      rec["step_seconds"]) + n_rounds,
                  f"{tag}: the replicas of node {p} differ after a step")
        joined = {k: {"params": v["params"], "lam": join_digest(v["lam"]),
                      "bar": join_digest(v["bar"]),
                      **({"ledger": join_digest(v["ledger"])} if async_
                         else {})}
                  for k, v in got_nodes.items()}
        check(joined == one["nodes"], f"{tag}: node rows differ: "
              + str([k for k in one["nodes"]
                     if joined.get(k) != one["nodes"][k]]))
        bound = row_bound_ms(st, deg, codec, lay.block_size)
        print(f"{tag}: J {SHARD_NODES} x S {SHARD_S} gloo ranks sharing "
              f"the card; rows, eta, mask, rounds and each node's replicas "
              + ("and ledger slabs, w_prev " if async_ else "")
              + f"equal the one-process run bit for bit; {rec['wire_bytes']} "
              f"wire bytes per node per offset; one process "
              f"{one['seconds']:.1f} s (peak {one['peak_gb']:.2f} GB, kernel "
              "ms " + " ".join(f"{t:.3f}" for t in one["ms"])
              + f", step median {np.median(rec['step_seconds']):.3f}) "
              f"[{card_line}]", flush=True)
        if async_:
            print(f"{tag}: staleness (stale_edges, age_max) "
                  + str([(x["stale_edges"], x["age_max"])
                         for x in rec["rounds"]]), flush=True)
        for r in mine:
            print(f"{tag} rank {r['rank']} (pod {r['pod']}, slab "
                  f"{r['shard']}, {r['device']}): peak {r['peak_gb']:.2f} GB "
                  f"({r['reserved_gb']:.2f} reserved; reckoned "
                  f"{reckoned[tag_]['peak'] / 1e9:.2f}); slab kernel ms "
                  + " ".join(f"{t:.3f}" for t in r["kernel_ms"])
                  + f" (bound {bound:.3f} at [1, {st}]); exchange s a round "
                  + " ".join(f"{t:.3f}" for t in r["exchange_s"])
                  + " (exposed wait "
                  + " ".join(f"{t:.3f}" for t in r["wait_s"])
                  + "); in-pod gathers s a round "
                  + " ".join(f"{t:.3f}" for t in r["gather_s"])
                  + f"; pinned staging {r['staging_bytes'] / 1e9:.3f} GB"
                  + f"; step median {np.median(r['step_seconds']):.3f}, "
                  f"round median "
                  f"{np.median([x['seconds'] for x in r['rounds']]):.3f} "
                  f"[{card_line}]", flush=True)
        # a rank's first launch loads the kernel's module (lazy loading),
        # so the median leaves out each process's first launch
        timed = [t for r in mine
                 for t in r["kernel_ms"][1 if n == 0 else 0:]]
        out[tag_] = dict(
            launches=sum(r["counts"]["masked_launches" if async_
                                     else "launches"] for r in mine),
            kernel_ms=float(np.median(timed)),
            first_launch_ms=(float(np.median([r["kernel_ms"][0]
                                              for r in mine]))
                             if n == 0 else None),
            bound_ms=bound,
            exchange_s=float(np.median([t for r in mine
                                        for t in r["exchange_s"]])),
            wait_s=float(np.median([t for r in mine for t in r["wait_s"]])),
            gather_s=float(np.median([t for r in mine
                                      for t in r["gather_s"]])),
            peak_gb=max(r["peak_gb"] for r in mine),
            reckoned_gb=reckoned[tag_]["peak"] / 1e9)
    out["seconds"] = call_s + sum(o["seconds"] for o in ones.values())
    return out


def pipe_slice(card_line):
    """Phase 27: ``PIPE_ARGS`` on each run of ``PIPE_RUNS`` (synchronous
    static native rounds; async fp8_e4m3 rounds with node 0 4x slow), at
    ``pipeline_offsets`` 1 in this process (J 3 on the card), then at
    ``PIPE_DEPTH`` in one torchrun call of three gloo ranks sharing the
    card, a node a rank, which also runs the synchronous run again at
    depth 1: every node's rows, eta, the mask, the ledger's rows and
    w_prev and every round's metrics equal bit for bit. Prints each
    rank's peak beside the reckoned one, its pinned staging bytes, each
    round's exchange issue seconds, exposed wait and probe seconds, and
    the kernel's ms beside the row's byte bound; and the synchronous
    run's exposed wait and round seconds at both depths on the same
    ranks."""
    from repro_torch import resolve_device
    from repro_torch.distributed import trivial_grid
    from repro_torch.models import build_model
    cfg = zoo_config(PIPE_ARCH, PIPE_LAYERS)
    params = build_model(cfg).param_count()
    runs = {tag: PIPE_ARGS + extra for tag, extra in PIPE_RUNS.items()}
    t0 = time.perf_counter()
    ones = one_process_runs(
        cfg, {t: a + ["--pipeline-offsets", "1"] for t, a in runs.items()},
        lambda: trivial_grid(PIPE_NODES, resolve_device(DEV)))
    one_s = time.perf_counter() - t0
    lay = ones["sync native"]["record"]["layout"]
    total, deg = lay.total, len(ones["sync native"]["record"]["offsets"])
    check(deg == 2, "phase 27: offsets "
          f"{ones['sync native']['record']['offsets']}")
    reckoned = {tag: reckon_pipe_peak(cfg, params, total, deg,
                                      a[a.index("--wire-codec") + 1],
                                      "--async" in a)
                for tag, a in PIPE_RUNS.items()}
    print(f"pipe: {PIPE_ARCH} x{PIPE_LAYERS} layers at full width, "
          f"{params} parameters a node, {total} elements a node row, J "
          f"{PIPE_NODES} ring (deg {deg}); one process at depth 1 "
          f"{one_s:.1f} s; reckoned peak a rank "
          + ", ".join(f"{t} {r['peak'] / 1e9:.2f} GB (resident "
                      f"{r['resident'] / 1e9:.2f}, local step "
                      f"{r['local'] / 1e9:.2f}, round {r['round'] / 1e9:.2f})"
                      for t, r in reckoned.items()), flush=True)
    # each run at PIPE_DEPTH, then the synchronous one at depth 1 on the
    # same ranks: what the depth changes in its exposed wait
    rank_runs = [(tag, a, PIPE_DEPTH) for tag, a in runs.items()] + [
        ("sync native", runs["sync native"], 1)]
    ranks, call_s = yield (
        "phase 27", PIPE_NODES, None, PIPE_LAYERS, dict(
            arch=PIPE_ARCH,
            runs=[a + ["--pipeline-offsets", str(dep), "--dist-backend",
                       "gloo"] for _, a, dep in rank_runs]))
    out = {"seconds": one_s + call_s}
    for n, (tag, args_list, dep) in enumerate(rank_runs):
        one = ones[tag]
        rec = one["record"]
        mine = [r["runs"][n] for r in ranks]
        n_rounds = len(rec["rounds"])
        codec = args_list[args_list.index("--wire-codec") + 1]
        async_ = "--async" in args_list
        want = want_counts(n_rounds, codec, async_)
        check(rec["counts"] == want,
              f"pipe {tag} one process: launches {rec['counts']}")
        got = {}
        for r in mine:
            got.update(r["nodes"])
            check(r["counts"] == want and len(r["kernel_ms"]) == n_rounds,
                  f"pipe {tag}: rank {r['rank']} launches {r['counts']}")
            check(r["replicated"] == one["rep"],
                  f"pipe {tag}: rank {r['rank']}'s replicated state "
                  f"{r['replicated']} != {one['rep']}")
            check(r["wire_bytes"] == rec["wire_bytes"],
                  f"pipe {tag}: wire bytes {r['wire_bytes']}")
            same_rounds(f"pipe {tag}", r, rec)
        check(got == one["nodes"], f"pipe {tag}: node rows differ: "
              + str([k for k in one["nodes"]
                     if got.get(k) != one["nodes"][k]]))
        if async_:
            stale = [x["stale_edges"] for x in rec["rounds"]]
            check(max(stale) > 0 and min(stale) == 0,
                  f"pipe {tag}: staleness {stale}")
        bound = row_bound_ms(total, deg, codec, lay.block_size)
        print(f"pipe {tag}: {PIPE_NODES} gloo ranks sharing the card at "
              f"pipeline_offsets {dep}; rows, eta, mask"
              + (", ledger rows, w_prev" if async_ else "")
              + " and rounds equal the one-process run at depth 1 bit for "
              f"bit; {rec['wire_bytes']} wire bytes per node per offset; one "
              f"process {one['seconds']:.1f} s (peak {one['peak_gb']:.2f} "
              "GB, kernel ms " + " ".join(f"{t:.3f}" for t in one["ms"])
              + f"); launches a rank {want} [{card_line}]", flush=True)
        for r in mine:
            print(f"pipe {tag} depth {dep} rank {r['rank']} "
                  f"({r['device']}): peak "
                  f"{r['peak_gb']:.2f} GB ({r['reserved_gb']:.2f} reserved; "
                  f"reckoned {reckoned[tag]['peak'] / 1e9:.2f}; the state "
                  f"{r['state_gb']:.2f} at the end, {r['left_gb']:.2f} left "
                  "after it); pinned "
                  f"staging {r['staging_bytes'] / 1e9:.3f} GB; exchange "
                  "issue s a round "
                  + " ".join(f"{t:.3f}" for t in r["issue_s"])
                  + "; exposed wait s " + " ".join(f"{t:.3f}"
                                                   for t in r["wait_s"])
                  + "; probes s " + " ".join(f"{t:.3f}"
                                             for t in r["probe_s"])
                  + "; kernel ms " + " ".join(f"{t:.3f}"
                                              for t in r["kernel_ms"])
                  + f" (bound {bound:.3f} a row); step median "
                  f"{np.median(r['step_seconds']):.3f}, round median "
                  f"{np.median([x['seconds'] for x in r['rounds']]):.3f} "
                  f"[{card_line}]", flush=True)
        out[tag if dep == PIPE_DEPTH else f"{tag} depth {dep}"] = dict(
            depth=dep,
            launches=sum(r["counts"]["masked_launches" if async_
                                     else "launches"] for r in mine),
            per_block=sum(r["counts"]["per_block_launches"] for r in mine),
            # each process's first launch loads the module (run (a))
            kernel_ms=float(np.median([t for r in mine for t in
                                       r["kernel_ms"][1 if n == 0 else 0:]])),
            bound_ms=bound,
            issue_s=float(np.median([t for r in mine for t in r["issue_s"]])),
            wait_s=float(np.median([t for r in mine for t in r["wait_s"]])),
            probe_s=float(np.median([t for r in mine for t in r["probe_s"]])),
            # each rank's last round: the first grows the pinned pool
            last_wait_s=[r["wait_s"][-1] for r in mine],
            last_round_s=[r["rounds"][-1]["seconds"] for r in mine],
            staging_gb=max(r["staging_bytes"] for r in mine) / 1e9,
            peak_gb=max(r["peak_gb"] for r in mine),
            reckoned_gb=reckoned[tag]["peak"] / 1e9)
    d2, d1 = out["sync native"], out["sync native depth 1"]
    print(f"pipe sync native: depth {PIPE_DEPTH} against depth 1 on the "
          "same ranks (each rank's last round; the depth-1 run came last): "
          "exposed wait s " + " ".join(f"{t:.3f}" for t in d2["last_wait_s"])
          + " against " + " ".join(f"{t:.3f}" for t in d1["last_wait_s"])
          + "; round s " + " ".join(f"{t:.3f}" for t in d2["last_round_s"])
          + " against " + " ".join(f"{t:.3f}" for t in d1["last_round_s"])
          + f"; pinned staging {d2['staging_gb']:.3f} against "
          f"{d1['staging_gb']:.3f} GB a rank [{card_line}]", flush=True)
    return out


def nccl1_slice(static, card_line):
    """Phase 25: the static slice's arguments as one rank over NCCL,
    against the static slice's run in this process (``static``)."""
    ranks, call_s = launch_ranks(
        "nccl1", 1, SLICE_ARGS + ["--wire-codec", "native",
                                  "--dist-backend", "nccl"], SLICE_LAYERS)
    same_run("nccl1", ranks, static["nodes"], static["replicated"],
             static["rounds"])
    r = ranks[0]
    n_rounds = len(static["rounds"])
    check(r["counts"] == {"launches": n_rounds, "masked_launches": 0,
                          "per_block_launches": 0},
          f"nccl1: launches {r['counts']}")
    print(f"nccl1: one rank over NCCL ({r['device']}), state and rounds "
          f"equal the static slice's bit for bit; kernel ms per round "
          + " ".join(f"{t:.3f}" for t in r["kernel_ms"])
          + "; exchange s per round " + " ".join(f"{t:.3f}"
                                                 for t in r["exchange_s"])
          + f"; step median {np.median(r['step_seconds']):.3f}; peak "
          f"{r['peak_gb']:.2f} GB; torchrun {call_s:.1f} s [{card_line}]",
          flush=True)
    return dict(launches=r["counts"]["launches"], seconds=call_s)


# -- the paper slice: dense ConsensusADMM and D-PPCA ---------------------
PAPER_WORKERS = 4          # CPU processes running the port's CPU side
SCHEMES = ("fixed", "vp", "ap", "nap", "vp_ap", "vp_nap")
FIG3_SETTINGS = (("ring", 50), ("complete", 50), ("complete", 5))
# scale_sfm: the structure angle after 50 iterations must stay below this.
# The port on the CPU at a reduced size (turntable, 5 cameras, frames 300,
# points 2,000; nap, complete, 50 iterations) reached 0.3505 degrees
# (tests/test_torch_ppca.py::test_sfm_angle_at_reduced_scale holds it
# under 0.5); the bound leaves about 3x.
SFM_ANGLE_BOUND_DEG = 1.0


def _synced(dev):
    import torch
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def fig2_run(topo, scheme, dev):
    """One paper_fig2 run (§5.1: 500 x 20 subspace data over 20 nodes,
    M 5, one init from seed 100) on ``dev``."""
    import torch
    from repro_torch.core import PenaltyConfig, build_graph
    from repro_torch.ppca import DPPCA, max_subspace_angle, subspace_data
    data = subspace_data(20, seed=0)
    x = torch.as_tensor(data.x, device=dev)
    eng = DPPCA(latent_dim=5, graph=build_graph(topo, 20),
                penalty_cfg=PenaltyConfig(scheme=scheme, eta0=10.0))
    st = eng.init(x, torch.Generator().manual_seed(100))
    t0 = time.perf_counter()
    st, hist = eng.run(st, x, max_iters=400, rel_tol=1e-3, min_iters=10)
    _synced(dev)
    seconds = time.perf_counter() - t0
    angle = float(max_subspace_angle(
        st.W, torch.as_tensor(data.W_true, device=dev)))
    return {"iters": hist["iterations"], "seconds": seconds, "angle": angle,
            "W": st.W.cpu().numpy()}


def fig3_run(topo, t_max, scheme, dev):
    """One paper_fig3 run (§5.2: turntable SfM, 5 cameras, 30 frames, 90
    points; the structure against fit_svd of the pooled measurements)."""
    import torch
    from repro_torch.core import PenaltyConfig, build_graph
    from repro_torch.ppca import DPPCA, fit_svd, max_subspace_angle
    from repro_torch.ppca import turntable_sfm
    sfm = turntable_sfm(5, frames=30, points=90, seed=0)
    x = torch.as_tensor(sfm.x_nodes, device=dev)
    ref = fit_svd(torch.as_tensor(sfm.measurements, device=dev), 3)
    eng = DPPCA(latent_dim=3, graph=build_graph(topo, 5),
                penalty_cfg=PenaltyConfig(scheme=scheme, eta0=10.0,
                                          t_max=t_max, t_reset=t_max))
    st = eng.init(x, torch.Generator().manual_seed(0))
    t0 = time.perf_counter()
    st, hist = eng.run(st, x, max_iters=400, rel_tol=1e-3, min_iters=10)
    _synced(dev)
    seconds = time.perf_counter() - t0
    return {"iters": hist["iterations"], "seconds": seconds,
            "angle": float(max_subspace_angle(st.W, ref.W)),
            "W": st.W.cpu().numpy()}


def lsq_run(topo, scheme, dev):
    """One quickstart run in float64 (J 8, d 5, n 20, inner 30,
    inner_lr 1.0, rel_tol 1e-8)."""
    import torch
    from repro_torch.examples import quickstart
    data, theta0, w_star = quickstart.lsq_problem(dtype=torch.float64,
                                                  device=dev)
    t0 = time.perf_counter()
    row, = quickstart.run_schemes(data, theta0, w_star, topologies=(topo,),
                                  schemes=(scheme,))
    _synced(dev)
    return {"iters": row["iterations"], "seconds": time.perf_counter() - t0,
            "err": row["err"], "W": row["w"]}


def dyn_run(dev):
    """The dynamic-topology example's three acts in float64."""
    import torch
    from repro_torch.examples import dynamic_topology
    t0 = time.perf_counter()
    out = dynamic_topology.three_acts(dtype=torch.float64, device=dev)
    _synced(dev)
    out["seconds"] = time.perf_counter() - t0
    return out


PAPER_RUNS = {"fig2": fig2_run, "fig3": fig3_run, "lsq": lsq_run,
              "dyn": dyn_run}


def paper_job(kind, args):
    """A CPU-side run in a worker process (one thread: the card's host
    keeps its own cores)."""
    import torch
    torch.set_num_threads(1)
    return PAPER_RUNS[kind](*args, "cpu")


def paper_jobs():
    """Every paper phase's runs, in phase order: (phase, kind, args)."""
    jobs = [("paper_fig2", "fig2", (t, s))
            for t in ("complete", "ring", "cluster") for s in SCHEMES]
    jobs += [("paper_fig3", "fig3", (t, tm, s))
             for t, tm in FIG3_SETTINGS for s in SCHEMES]
    jobs += [("paper_lsq", "lsq", (t, s))
             for t in ("complete", "ring") for s in SCHEMES]
    jobs.append(("paper_lsq", "dyn", ()))
    return jobs


def no_kernel_launched(phase):
    """The paper slice reaches no CUDA kernel of the port."""
    counts = {f"{obj.__name__}.{attr}": getattr(obj, attr)
              for obj, attr in all_counters()}
    check(not any(counts.values()),
          f"{phase}: the paper path launched a kernel: {counts}")


def paper_phases(card_line):
    """Phases 13-15: the paper's configurations on the card and, in worker
    processes started together, by the port on the CPU from the same
    inits; every run must agree (module docstring)."""
    import concurrent.futures as cf
    import multiprocessing as mp
    jobs = paper_jobs()
    pool = cf.ProcessPoolExecutor(PAPER_WORKERS,
                                  mp_context=mp.get_context("spawn"))
    try:
        futures = [pool.submit(paper_job, kind, args)
                   for _, kind, args in jobs]
        for phase in ("paper_fig2", "paper_fig3", "paper_lsq"):
            for obj, attr in all_counters():
                setattr(obj, attr, 0)
            t0 = time.perf_counter()
            mine = [(n, kind, args, PAPER_RUNS[kind](*args, DEV))
                    for n, (ph, kind, args) in enumerate(jobs) if ph == phase]
            seconds = time.perf_counter() - t0
            no_kernel_launched(phase)
            paper_compare(phase, mine, futures, seconds, card_line)
    finally:
        pool.shutdown(wait=True, cancel_futures=True)


def paper_compare(phase, mine, futures, seconds, card_line):
    """Hold each card run against its CPU run; print the phase's line."""
    iters = secs = 0
    for n, kind, args, card in mine:
        cpu = futures[n].result()
        tag = f"{phase} {kind} {'/'.join(map(str, args))}"
        if kind == "dyn":
            dyn_compare(tag, card, cpu)
            iters += card["iterations"] + 20 * len(card["shed"]) + 30
            secs += card["seconds"]
            continue
        iters += card["iters"]
        secs += card["seconds"]
        check(card["iters"] == cpu["iters"],
              f"{tag}: {card['iters']} iterations on the card, "
              f"{cpu['iters']} on the CPU")
        scale = float(np.abs(cpu["W"]).max())
        w_err = float(np.abs(card["W"] - cpu["W"]).max())
        check(w_err <= 1e-8 * scale, f"{tag}: W differs by {w_err:.3g} "
              f"(max|W| {scale:.3g})")
        if kind == "lsq":
            check(card["err"] < 1e-3, f"{tag}: max|w - w*| {card['err']}")
        else:
            check(abs(card["angle"] - cpu["angle"]) <= 1e-5,
                  f"{tag}: angle {card['angle']} on the card, "
                  f"{cpu['angle']} on the CPU")
        print(f"  {tag}: {card['iters']} iterations, "
              + (f"max|w-w*| {card['err']:.3g}" if kind == "lsq"
                 else f"angle {card['angle']:.4f} deg")
              + f", {1e3 * card['seconds'] / card['iters']:.3f} ms/iter; "
              f"W card vs cpu {w_err:.3g}", flush=True)
    ms = 1e3 * secs / iters
    print(f"{phase}: {len(mine)} runs, {iters} iterations, {seconds:.2f} s "
          f"on the card, {ms:.3f} ms per iteration (host clock around run, "
          f"synchronized), every run equal to the CPU's; {card_line}",
          flush=True)


def dyn_compare(tag, card, cpu):
    """The dynamic example's masks and active edges at every print equal,
    and the survivors agree."""
    check(card["iterations"] == cpu["iterations"],
          f"{tag}: act 1 {card['iterations']} vs {cpu['iterations']}")
    prints = [(card["mask"], cpu["mask"], None, None)]
    prints += [(a["mask"], b["mask"], a["active_edges"], b["active_edges"])
               for a, b in zip(card["shed"], cpu["shed"])]
    prints.append((card["churn"]["mask"], cpu["churn"]["mask"],
                   card["churn"]["active_edges"],
                   cpu["churn"]["active_edges"]))
    for k, (ma, mb, ea, eb) in enumerate(prints):
        check(np.array_equal(ma, mb) and ea == eb,
              f"{tag}: print {k}: masks or active edges differ "
              f"({ea} vs {eb})")
    c = card["churn"]
    check(c["alive"] == 11 and c["spread"] < 1e-3,
          f"{tag}: survivors {c}")
    print(f"  {tag}: act 1 {card['iterations']} iterations, active edges "
          + ", ".join(f"{r['active_edges']:.2f}" for r in card["shed"])
          + f", after the drop {c['active_edges']:.2f}, survivors' spread "
          f"{c['spread']:.3g}; masks equal to the CPU's at every print",
          flush=True)


def profile_iteration(step, label):
    """One call of ``step`` under torch.profiler (CUDA activity): its wall
    ms (host clock, synchronized), device busy ms, idle share and kernel
    launches."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    _, busy_ms, _, top = device_profile(prof, top_n=4)
    launches = sum(1 for ev in prof.events()
                   if ev.device_type == DeviceType.CUDA
                   and not ev.name.lower().startswith(("memcpy", "memset")))
    idle = 1.0 - busy_ms / wall_ms
    print(f"  {label} under the profiler: {wall_ms:.2f} ms, device busy "
          f"{busy_ms:.2f} ms, idle {100 * idle:.1f}%, {launches} kernel "
          f"launches; top: " + ", ".join(
              f"{name[:40]} x{n} {ms:.2f} ms" for name, (n, ms) in top),
          flush=True)


def solve_graph_check(card_line, reps=10):
    """The inner solver at the quickstart's size (float64, J 8, nap, one
    step in): eager against its CUDA-graph replay, which the engine uses
    on the card. Equal bit for bit; both timed (host clock, synchronized)."""
    import torch
    from repro_torch.core import ConsensusADMM, PenaltyConfig, build_graph
    from repro_torch.examples.quickstart import lsq_problem, objective
    data, theta0, _ = lsq_problem(dtype=torch.float64, device=DEV)
    eng = ConsensusADMM(objective=objective,
                        penalty_cfg=PenaltyConfig(scheme="nap", eta0=1.0),
                        graph=build_graph("ring", 8), inner_steps=30,
                        inner_lr=1.0)
    st, _ = eng.step(eng.init(theta0), data)
    adj, scale = eng._device_consts(st.penalty.eta.device)
    args = (data, st.theta, st.lam, st.penalty.eta * scale, adj)
    times, outs = {}, {}
    for name, solve in (("eager", eng._solve_gradient),
                        ("graph", eng._solve_graphed)):
        outs[name] = solve(*args)["w"]           # the graph's capture
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            got = solve(*args)["w"]
        torch.cuda.synchronize()
        times[name] = 1e3 * (time.perf_counter() - t0) / reps
        check(torch.equal(got, outs[name]), f"{name} solve not repeatable")
    check(torch.equal(outs["eager"], outs["graph"]),
          "the graphed inner solve differs from the eager one")
    print(f"solve_graph: inner solve (30 vmapped grad/vjp steps, J 8, "
          f"float64) eager {times['eager']:.2f} ms, CUDA graph "
          f"{times['graph']:.3f} ms, equal bit for bit; {card_line}",
          flush=True)


def scale_lsq(card_line, j=16, n=8192, d=2048, inner=30, iters=10):
    """Phase 16: ConsensusADMM least squares in float32 with 1.07 GB of
    data on the card; held against torch.linalg.lstsq of the stacked
    problem."""
    import torch
    from repro_torch.core import (ConsensusADMM, PenaltyConfig, build_graph,
                                  consensus_error)
    from repro_torch.examples.quickstart import objective
    for obj, attr in all_counters():
        setattr(obj, attr, 0)
    gen = torch.Generator(device=DEV).manual_seed(0)
    A = torch.randn(j, n, d, generator=gen, device=DEV)
    w_true = torch.randn(d, generator=gen, device=DEV)
    b = A @ w_true + 0.05 * torch.randn(j, n, generator=gen, device=DEV)
    theta0 = {"w": torch.randn(j, d, generator=gen, device=DEV)}
    w_star = torch.linalg.lstsq(A.reshape(-1, d),
                                b.reshape(-1, 1)).solution[:, 0]
    eng = ConsensusADMM(objective=objective,
                        penalty_cfg=PenaltyConfig(scheme="nap", eta0=1.0),
                        graph=build_graph("complete", j), inner_steps=inner,
                        inner_lr=1.0)
    data = (A, b)
    err0 = float((theta0["w"] - w_star).abs().max())
    cons0 = float(consensus_error(theta0))
    state = eng.init(theta0)
    eng.step(state, data)                       # warm-up (allocator, cuBLAS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, hist = eng.run(state, data, max_iters=iters, rel_tol=0.0)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    no_kernel_launched("scale_lsq")
    err = float((state.theta["w"] - w_star).abs().max())
    cons = float(consensus_error(state.theta))
    check(hist["iterations"] == iters and err * 10 <= err0
          and cons * 10 <= cons0,
          f"scale_lsq: max|w-w*| {err0:.4g} -> {err:.4g}, consensus error "
          f"{cons0:.4g} -> {cons:.4g} (want each 10x smaller)")
    ms = 1e3 * seconds / iters
    # each inner step reads A four times (the gradient's A w and A^T r,
    # the Hessian-vector product's two), plus one pass each for f_self
    # and the probes: that read alone takes this long at 3.35 TB/s
    floor_ms = 1e3 * (4 * inner + 2) * A.numel() * 4 / HBM_BYTES_PER_S
    profile_iteration(lambda: eng.step(state, data), "scale_lsq")
    print(f"scale_lsq: J {j} x A [{n}, {d}] float32 ({A.numel() * 4 / 1e9:.2f}"
          f" GB), nap, complete, inner {inner}: {iters} iterations in "
          f"{seconds:.3f} s, {ms:.2f} ms per iteration (A-read floor "
          f"{floor_ms:.2f} ms); max|w-w*| {err0:.4g} -> {err:.4g}, "
          f"consensus error {cons0:.4g} -> {cons:.4g}; {card_line}",
          flush=True)
    del A, b, data, state, eng
    torch.cuda.empty_cache()


def scale_sfm(card_line, frames=300, points=20000, iters=50):
    """Phase 17: D-PPCA on turntable SfM with 96 MB of observations; the
    [J, J] probe broadcast is about 0.5 GB."""
    import torch
    from repro_torch.core import PenaltyConfig, build_graph
    from repro_torch.ppca import (DPPCA, fit_svd, max_subspace_angle,
                                  turntable_sfm)
    for obj, attr in all_counters():
        setattr(obj, attr, 0)
    torch.cuda.reset_peak_memory_stats()
    sfm = turntable_sfm(5, frames=frames, points=points, seed=0)
    x = torch.as_tensor(sfm.x_nodes, device=DEV)
    ref = fit_svd(torch.as_tensor(sfm.measurements, device=DEV), 3)
    eng = DPPCA(latent_dim=3, graph=build_graph("complete", 5),
                penalty_cfg=PenaltyConfig(scheme="nap", eta0=10.0))
    state = eng.init(x, torch.Generator().manual_seed(0))
    angle0 = float(max_subspace_angle(state.W, ref.W))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, hist = eng.run(state, x, max_iters=iters, rel_tol=0.0,
                          min_iters=iters)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    no_kernel_launched("scale_sfm")
    angle = float(max_subspace_angle(state.W, ref.W))
    check(hist["iterations"] == iters and angle < angle0
          and angle < SFM_ANGLE_BOUND_DEG,
          f"scale_sfm: structure angle {angle0:.4f} -> {angle:.4f} deg "
          f"(bound {SFM_ANGLE_BOUND_DEG})")
    ms = 1e3 * seconds / iters
    peak = torch.cuda.max_memory_allocated() / 1e9
    profile_iteration(lambda: eng.step(state, x), "scale_sfm")
    print(f"scale_sfm: turntable {frames} frames x {points} points "
          f"({x.numel() * 8 / 1e6:.0f} MB float64), 5 cameras, nap, "
          f"complete: {iters} iterations in {seconds:.3f} s, {ms:.2f} ms "
          f"per iteration; structure angle {angle0:.4f} -> {angle:.4f} deg "
          f"(bound {SFM_ANGLE_BOUND_DEG}); peak {peak:.2f} GB; {card_line}",
          flush=True)


# -- the model zoo: phases 20-23 --------------------------------------------
def zoo_flash(card_line):
    """Phase 20: the flash kernels at the zoo's shapes no earlier phase
    launches, each against its plain version under phase 9's bounds and
    timed beside the library and the bound: stablelm-3b's hd 80 (32/32
    heads) and kimi-k2's hd 112 (64 heads after the model's repeat), bf16
    on the tensor-core kernel (the padded tile), at most TC_LIBRARY_RATIO
    times the library on the same inputs, and f32 on the cc kernel; the
    tensor-core kernel at hymba's 25 heads of 64 with a window of 1024 at
    S 2048."""
    out = {}
    for hd, h, seed in ((80, 32, 51), (112, 64, 53)):
        for dtype in ("bfloat16", "float32"):
            rec = flash_case(f"hd{hd} {dtype}", card_line, h=h, kv=h, hd=hd,
                             dtype=dtype, seed=seed + (dtype == "float32"))
            want = "tc" if dtype == "bfloat16" else "cc"
            check(rec["route"] == want, f"flash hd{hd} {dtype}: routed to "
                  f"{rec['route']}, want {want}")
            if want == "tc":
                check_tc_against_library(f"hd{hd} {dtype}", rec)
            out[f"hd{hd}_{dtype}"] = rec
    rec = flash_case("hymba", card_line, h=25, kv=25, hd=64, s=2048,
                     window=1024, seed=55)
    check(rec["route"] == "tc", f"flash hymba: routed to {rec['route']}")
    out["hymba"] = rec
    return out


def zoo_config(arch, layers):
    """``arch``'s full-width config, cut to ``layers`` unless None."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    return cfg if layers is None else dataclasses.replace(cfg,
                                                          n_layers=layers)


def zoo_layer_check(cfg, params, batch) -> float:
    """Phase 21: the first layer's attention on the served prompt's own
    activations, through ``ops.flash_attention`` (the routed kernel) against
    the plain attention evaluated in f32 and cast to bf16, within phase 9's
    bf16 bound of 2e-2 (of max|out| where that exceeds 1). The launch is a
    check, not the path: the counters are put back."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import attention as attn_lib
    from repro_torch.models.layers import apply_rope, embed_tokens, rms_norm
    from repro_torch.models.transformer import _layer
    with torch.inference_mode():
        x = (batch["embeds"] if "embeds" in batch
             else embed_tokens(params, batch["tokens"])).to(torch.bfloat16)
        lp = _layer(params, 0)
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        cos, sin = attn_lib.make_rope(cfg, x.shape[1], device=x.device)
        q, k, v = attn_lib._project_qkv(cfg, lp["attn"], h)
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        n_rep = q.shape[2] // k.shape[2]
        k, v = attn_lib._repeat_kv(k, n_rep), attn_lib._repeat_kv(v, n_rep)
        before = (ops.flash_attention.launches,
                  ops.flash_attention.tc_launches)
        got = ops.flash_attention(q, k, v, causal=True,
                                  window=cfg.sliding_window)
        torch.cuda.synchronize()
        ops.flash_attention.launches, ops.flash_attention.tc_launches = \
            before
        want = attn_lib.flash_ref(q.float(), k.float(), v.float(),
                                  causal=True, window=cfg.sliding_window)
        err = float((got.float() - want).abs().max())
        scale = float(want.abs().max())
    tol = 2e-2 * max(1.0, scale)
    check(got.dtype == torch.bfloat16 and err <= tol,
          f"zoo serve {cfg.arch_id}: layer 0's attention through the kernel "
          f"differs from the plain version by {err:.3g} (max|out| "
          f"{scale:.3g}, bound {tol:.3g})")
    return err


def zoo_serve(arch, card_line):
    """Phase 21: ``launch.serve.run`` at full width (kimi-k2 at one layer)
    with every counter from 0: the prefill launches the routed flash kernel
    once per layer and nothing else, the decode none; every logit finite;
    the kernel on layer 0's activations against the plain version. The
    kernel's device time in the served prefill comes from CUDA events
    around each of its launches (a profiler trace of hymba's prefill, some
    400,000 launches of its SSM loop, took longer than the run). Returns
    the launches and times."""
    import gc
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import serve
    from repro_torch.models import build_model
    layers, prompt = ZOO_SERVE[arch]
    cfg = zoo_config(arch, layers)
    args = serve.parse_args(["--arch", arch, "--batch", "4", "--prompt-len",
                             str(prompt), "--gen-len", str(ZOO_GEN),
                             "--device", DEV])
    route = fa.route(torch.bfloat16, cfg.head_dim)
    n = cfg.n_layers
    launch, timed = fa.launch, []

    def timed_launch(*a, **kw):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = launch(*a, **kw)
        ev[1].record()
        timed.append(ev)
        return out

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for obj, attr in all_counters():
        setattr(obj, attr, 0)
    fa.launch = timed_launch
    try:
        t0 = time.perf_counter()
        record = serve.run(cfg, args)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    finally:
        fa.launch = launch
    counts = {f"{obj.__name__}.{attr}": getattr(obj, attr)
              for obj, attr in all_counters()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = dict.fromkeys(counts, 0)
    want["flash_attention.launches"] = n
    want["flash_attention.tc_launches"] = n if route == "tc" else 0
    check(counts == want, f"zoo serve {arch}: launches {counts}, want {want}")
    check(record["prefill_launches"]["flash_attention"] == n
          and not any(record["decode_launches"].values()) and len(timed) == n,
          f"zoo serve {arch}: prefill launches {record['prefill_launches']}, "
          f"decode launches {record['decode_launches']}, {len(timed)} timed")
    logits = record["prefill_logits"]
    b, s = args.batch, args.prompt_len
    finite = all(bool(torch.isfinite(t).all()) for t in (
        logits, record["replay_logits"], record["step_logits"]))
    check(tuple(logits.shape) == (b, s, cfg.vocab) and finite,
          f"zoo serve {arch}: prefill logits {tuple(logits.shape)}, all "
          f"finite {finite}")
    toks = record["tokens"]
    check(tuple(toks.shape) == (b, ZOO_GEN) and int(toks.min()) >= 0
          and int(toks.max()) < cfg.vocab,
          f"zoo serve {arch}: tokens {tuple(toks.shape)}")
    in_prefill = [x.elapsed_time(y) for x, y in timed]
    layer_err = zoo_layer_check(cfg, record["params"], record["batch"])
    count = build_model(cfg).param_count()
    print(f"zoo serve {arch}: {n} layers at full width "
          f"({count / 1e9:.2f} B parameters; reckoned "
          f"{ZOO_PARAMS_B[arch]:.2f} B), batch {b}, prompt {s}, {ZOO_GEN} "
          f"tokens; flash launches {n}, "
          f"{counts['flash_attention.tc_launches']} on the tensor-core "
          f"kernel ({route} route, hd {cfg.head_dim}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads, window "
          f"{cfg.sliding_window}); prefill {record['prefill_ms']:.2f} ms, "
          f"decode {record['decode_ms_per_token']:.3f} ms per token, "
          f"{wall_s:.1f} s in all (replay included); flash in the prefill "
          f"median {np.median(in_prefill):.4f} ms, sum "
          f"{sum(in_prefill):.3f} ms; layer 0's attention kernel vs plain "
          f"{layer_err:.3g}; peak memory {peak_gb:.2f} GB [{card_line}]",
          flush=True)
    out = dict(launches=n, route=route, param_count=count,
               in_prefill_ms=float(np.median(in_prefill)),
               in_prefill_sum_ms=float(sum(in_prefill)),
               prefill_ms=record["prefill_ms"],
               decode_ms=record["decode_ms_per_token"], peak_gb=peak_gb,
               seconds=wall_s)
    del record, logits, toks
    gc.collect()
    torch.cuda.empty_cache()
    return out


def zoo_train(arch, card_line):
    """Phase 22: ``launch.train.run`` at full width with depth cut
    (``ZOO_TRAIN_LAYERS``): 2 nodes, ring, nap, native wire, 4 steps of 4 x
    512 tokens per node with a round after every second one. Every round
    launches the ungated kernel once (counters from 0) and none other; its
    device time in each round comes from CUDA events around the launch,
    beside its byte bound. Returns the launches and times."""
    import gc
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_lib
    from repro_torch.models import build_model
    cfg = zoo_config(arch, ZOO_TRAIN_LAYERS[arch])
    args = train_lib.parse_args(["--arch", arch] + ZOO_TRAIN_ARGS)
    n_rounds = args.steps // args.local_steps
    launch, timed = ops._cu.launch, []

    def timed_launch(theta, lam, bar_prev, wires, scales, e_sym, *rest,
                     **kw):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        bound = round_bound(theta, lam, bar_prev, wires, scales, e_sym,
                            rest[3])[0]
        a.record()
        out = launch(theta, lam, bar_prev, wires, scales, e_sym, *rest, **kw)
        b.record()
        timed.append((a, b, bound))
        return out

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for obj, attr in all_counters():
        setattr(obj, attr, 0)
    ops._cu.launch = timed_launch
    try:
        t0 = time.perf_counter()
        record = train_lib.run(cfg, args)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    finally:
        ops._cu.launch = launch
    launches, masked, per_block = (getattr(ops.consensus_round, c)
                                   for c in COUNTS)
    others = {f"{obj.__name__}.{attr}": getattr(obj, attr)
              for obj, attr in all_counters()[3:]}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses, rounds = record["losses"], record["rounds"]
    check(len(losses) == args.steps and all(map(math.isfinite, losses)),
          f"zoo train {arch}: losses {losses}")
    check(len(rounds) == n_rounds and all(
        math.isfinite(r["r_max"]) and math.isfinite(r["eta_mean"])
        for r in rounds), f"zoo train {arch}: rounds {rounds}")
    check(launches == n_rounds and masked == 0 and per_block == 0
          and len(timed) == n_rounds and not any(others.values()),
          f"zoo train {arch}: {launches} ungated, {masked} gated, "
          f"{per_block} per-block launches in {n_rounds} rounds, others "
          f"{others} (training runs no attention or scan kernel)")
    kernel_ms = [a.elapsed_time(b) for a, b, _ in timed]
    bound_ms = timed[0][2]
    steps = record["step_seconds"]
    layout = record["layout"]
    count = build_model(cfg).param_count()
    print(f"zoo train {arch}: {cfg.n_layers} layers at full width, {count} "
          f"parameters per node, {layout.total} elements per node row, "
          f"{len(rounds)} rounds, ungated launches {launches}; local steps "
          + " ".join(f"{t:.3f}" for t in steps[0::2]) + " s, round steps "
          + " ".join(f"{t:.3f}" for t in steps[1::2]) + " s (rounds alone "
          + " ".join(f"{r['seconds']:.3f}" for r in rounds) + " s); "
          "consensus_round " + " ".join(f"{t:.3f}" for t in kernel_ms)
          + f" ms in rounds, bound {bound_ms:.3f} ms (bytes); wire "
          f"{record['wire_bytes']} bytes per node per offset; losses "
          + " ".join(f"{x:.4f}" for x in losses)
          + f"; other kernels {others}; peak memory {peak_gb:.2f} GB; "
          f"{wall_s:.1f} s [{card_line}]", flush=True)
    del record
    gc.collect()
    torch.cuda.empty_cache()
    return dict(launches=launches, in_round_ms=float(np.median(kernel_ms)),
                bound_ms=bound_ms, peak_gb=peak_gb, seconds=wall_s)


def zoo_agree(arch) -> None:
    """Phase 23: the reduced float32 arch on the card against the same on
    the CPU from the same weights: served prefill, replay and step logits
    within 1e-4 of their largest magnitude and greedy tokens equal (the
    card's prefill launching the kernel once per layer); then one local step
    and one consensus round (J 2, ring, nap): loss and eta to rtol 1e-3, and
    the duals to 5e-3 of their norm (one AdamW step moves a parameter by
    about lr times its gradient's sign, so where a gradient cancels to
    round-off the two devices move it differently: see
    tests/test_torch_zoo.py)."""
    import torch
    from repro_torch import tree as tree_lib
    from repro_torch.configs import get_reduced_config
    from repro_torch.core.penalty import PenaltyConfig
    from repro_torch.data import DataConfig, SyntheticTokens
    from repro_torch.launch import serve
    from repro_torch.models import build_model
    from repro_torch.models.model import stub_embeds
    from repro_torch.optim import ConsensusConfig, ConsensusTrainer
    from repro_torch.optim.adamw import AdamWConfig
    cfg = dataclasses.replace(get_reduced_config(arch), dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    s = 40 if cfg.sliding_window else 32      # past hymba's window of 32
    g = torch.Generator().manual_seed(1)
    stub = cfg.frontend != "none"
    if stub:
        inputs = dict(embeds=stub_embeds(cfg, (4, s), g, "cpu"))
        table = stub_embeds(cfg, (cfg.vocab, 4), g, "cpu")
    else:
        inputs = dict(prompts=torch.randint(0, cfg.vocab, (4, s),
                                            generator=g))
    recs = {}
    for dev in (DEV, "cpu"):
        args = serve.parse_args(["--device", dev, "--prompt-len", str(s),
                                 "--gen-len", "8"])
        kw = {k: v.to(dev) for k, v in inputs.items()}
        if stub:
            kw["step_embed"] = (lambda tok, d=dev:
                                table[int(tok[0])].to(d))
        recs[dev] = serve.run(cfg, args, params=tree_lib.tree_map(
            lambda a, d=dev: a.to(d), params), **kw)
    kernel = "rwkv6_scan" if cfg.rwkv else "flash_attention"
    check(recs[DEV]["prefill_launches"][kernel] == cfg.n_layers,
          f"zoo agree {arch}: prefill launches "
          f"{recs[DEV]['prefill_launches']}")
    check(torch.equal(recs[DEV]["tokens"].cpu(), recs["cpu"]["tokens"]),
          f"zoo agree {arch}: tokens differ")
    worst = 0.0
    for key in ("prefill_logits", "replay_logits", "step_logits"):
        a, b = recs[DEV][key].cpu(), recs["cpu"][key]
        worst = max(worst, float((a - b).abs().max()) / float(b.abs().max()))
    check(worst <= 1e-4, f"zoo agree {arch}: logits differ by {worst:.3g} "
          "of their largest magnitude")
    rounds = {}
    for dev in (DEV, "cpu"):
        tr = ConsensusTrainer(
            model, num_nodes=2, device=dev, adamw=AdamWConfig(lr=1e-2),
            consensus=ConsensusConfig(
                penalty=PenaltyConfig(scheme="nap", eta0=0.1),
                topology="ring", local_steps=1))
        data = SyntheticTokens(DataConfig(vocab=cfg.vocab, seq_len=32,
                                          batch_per_node=4, num_nodes=2),
                               device=dev)

        def make_batch(step, data=data):
            return (data.embeds_batch(step, cfg.d_model) if stub
                    else data.batch(step))

        state = tr.init_state(params)
        state, m = tr.train_step(state, make_batch(0))
        state, cm = tr.consensus_step(state, make_batch(10**6))
        rounds[dev] = (float(m["loss"]), float(cm["r_max"]),
                       state.penalty.eta.cpu(), state.lam.cpu())
    (l_c, r_c, eta_c, lam_c), (l_h, r_h, eta_h, lam_h) = (rounds[DEV],
                                                          rounds["cpu"])
    lam_rel = float((lam_c - lam_h).norm() / lam_h.norm())
    eta_rel = float(((eta_c - eta_h).abs() / eta_h.abs()).max())
    check(abs(l_c - l_h) <= 1e-3 * abs(l_h) and abs(r_c - r_h) <= 1e-3 * r_h
          and eta_rel <= 1e-3 and lam_rel <= 5e-3,
          f"zoo agree {arch}: loss {l_c} vs {l_h}, r_max {r_c} vs {r_h}, "
          f"eta {eta_rel:.3g}, lam {lam_rel:.3g} (relative)")
    print(f"zoo agree {arch}: reduced float32, card vs cpu: serve tokens "
          f"equal, logits within {worst:.3g} of their largest magnitude; one "
          f"round: loss {abs(l_c - l_h) / abs(l_h):.3g}, r_max "
          f"{abs(r_c - r_h) / r_h:.3g}, eta {eta_rel:.3g}, lam {lam_rel:.3g} "
          "(relative)", flush=True)


def ep_serve(cfg, mesh, params):
    """Phase 28's served run on ``mesh`` (the one-process mesh or a rank's):
    a prefill of the seeded prompts with ``use_kernel`` through
    ``make_serve_fns`` to warm up; one with ``mesh.stats`` on, for the
    drops and the all-to-all seconds (each exchange timed between two
    synchronisations of the device, so this pass is not timed); then,
    with every counter from 0, the timed prefill and ``EP_DECODE`` decode
    steps from an empty state fed the prompt's first tokens, on the mesh
    without stats (nothing synchronises inside). Times by the host clock
    between synchronisations. The timed prefill's logits must equal the
    instrumented one's bit for bit."""
    import torch
    from repro_torch.configs import ShapeCell
    from repro_torch.launch.steps import make_serve_fns
    from repro_torch.models import build_model
    model = build_model(cfg)
    prompts = torch.randint(
        0, cfg.vocab, (EP_BATCH, EP_PROMPT), device=DEV,
        generator=torch.Generator(DEV).manual_seed(EP_SEED + 1))
    cell = ShapeCell("ep", EP_PROMPT, EP_BATCH, "prefill")
    stats = mesh.stats
    prefill_fn, decode_fn = make_serve_fns(
        model, dataclasses.replace(mesh, stats=None), cell)
    traced_prefill, _ = make_serve_fns(model, mesh, cell)
    with torch.inference_mode():
        # a first prefill loads the kernel, makes cuBLAS's handles and (on
        # a rank) grows the pinned staging
        prefill_fn(params, {"tokens": prompts}, use_kernel=True)
        torch.cuda.synchronize()
        stats.clear()
        traced = digest(traced_prefill(params, {"tokens": prompts},
                                       use_kernel=True))
    for obj, attr in all_counters():
        setattr(obj, attr, 0)
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = prefill_fn(params, {"tokens": prompts}, use_kernel=True)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        counts = {f"{obj.__name__}.{attr}": getattr(obj, attr)
                  for obj, attr in all_counters()}
        state = model.init_decode_state(EP_BATCH, EP_PROMPT, DEV, mesh=mesh)
        steps = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(EP_DECODE):
            lg, state = decode_fn(params, state, {"token": prompts[:, i]})
            steps.append(lg)
        torch.cuda.synchronize()
        decode_ms = (time.perf_counter() - t0) * 1e3 / EP_DECODE
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(digest(logits) == traced, "phase 28: the prefill with the "
          "drops and all-to-all timed differs from the timed prefill")
    decode = torch.stack(steps)
    return dict(prompts=prompts, logits=logits, decode=decode,
                prefill_ms=prefill_ms, decode_ms=decode_ms, counts=counts,
                dropped=[d.tolist() for d in stats.dropped],
                lost=[t.cpu() for t in stats.lost],
                a2a_s=stats.seconds["a2a"], a2a_calls=stats.calls["a2a"],
                peak_gb=peak_gb)


def gloo_cuda_all_to_all(mesh) -> str:
    """Whether gloo's ``all_to_all_single`` takes CUDA tensors (a probe;
    the port stages through pinned host buffers either way)."""
    import torch
    import torch.distributed as dist
    n = mesh.model
    t = torch.arange(n * 4, dtype=torch.float32, device=mesh.device) \
        + 100 * mesh.coords[1]
    out = torch.empty_like(t)
    try:
        dist.all_to_all_single(out, t, group=mesh.model_group)
        torch.cuda.synchronize()
    except RuntimeError as err:
        return "raises: " + str(err).strip().splitlines()[0][:160]
    want = torch.cat([torch.arange(4, device=mesh.device) + 4 * mesh.coords[1]
                      + 100 * j for j in range(n)]).float()
    return "takes them" + ("" if torch.equal(out, want) else
                           ", but the rows came back WRONG")


def ep_worker(spec, cfg, rank, out_dir) -> int:
    """One rank of phase 28 (``chip_smoke.py --ranks-worker SPEC`` with
    ``"ep"`` in the spec): its mesh (``init_mesh``, gloo on the card), its
    shards only (its experts, heads and vocab rows, drawn leaf by leaf
    from the one process's seed), the served run; its digests and numbers
    into ``rank<r>.json``."""
    import torch
    from repro_torch.distributed import MeshStats, fsdp
    from repro_torch.launch.mesh import init_mesh
    from repro_torch.models import build_model
    mesh = init_mesh(*EP_MESH, DEV, backend="gloo", stats=MeshStats())
    try:
        torch.cuda.reset_peak_memory_stats()
        model = build_model(cfg)
        params = model.init(
            torch.Generator(DEV).manual_seed(EP_SEED), DEV, mesh=mesh,
            specs=fsdp.specs_for(model, mesh)[0])
        torch.cuda.synchronize()
        init_peak = torch.cuda.max_memory_allocated() / 1e9
        params_gb = torch.cuda.memory_allocated() / 1e9
        probe = gloo_cuda_all_to_all(mesh)
        run = ep_serve(cfg, mesh, params)
        out = dict(rank=rank, coords=list(mesh.coords),
                   device=str(mesh.device), probe=probe,
                   logits=digest(run["logits"]),
                   decode=[digest(t) for t in run["decode"]],
                   dropped=run["dropped"], prefill_ms=run["prefill_ms"],
                   decode_ms=run["decode_ms"], counts=run["counts"],
                   a2a_s=run["a2a_s"], a2a_calls=run["a2a_calls"],
                   peak_gb=run["peak_gb"], init_peak_gb=init_peak,
                   params_gb=params_gb, param_bytes=tree_bytes(params),
                   reckoned=fsdp.shard_bytes(model, mesh)["params"],
                   heads=params["blocks"]["attn"]["wq"].shape[2],
                   experts=params["blocks"]["moe"]["wg"].shape[1])
    finally:
        mesh.close()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    return 0


def ep_layer_check(cfg, params, prompts) -> float:
    """Phase 28 check 2: layer 0's MoE on the prompt's own activations, the
    all-to-all path on the one-process data 1 x model 2 mesh at capacity
    factor ``EP_CHECK_CF`` (where nothing drops), against ``moe_ref``,
    within 4 bf16 ulps of max|y| (``tests/test_torch_moe.py``'s bf16
    bound: each path rounds another product to bf16)."""
    import torch
    from repro_torch.distributed import MeshStats, local_mesh, use_mesh
    from repro_torch.models import attention as attn_lib
    from repro_torch.models import moe
    from repro_torch.models.layers import embed_tokens, rms_norm
    from repro_torch.models.transformer import _layer
    c = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=EP_CHECK_CF))
    stats = MeshStats()
    with torch.inference_mode():
        lp = _layer(params, 0)
        x = embed_tokens(params, prompts).to(lp["ln1"].dtype)
        cos, sin = attn_lib.make_rope(cfg, x.shape[1], device=x.device)
        x = x + attn_lib.attention(cfg, None, [lp["attn"]],
                                   rms_norm(x, lp["ln1"], cfg.norm_eps),
                                   cos, sin)
        h2 = rms_norm(x, lp["ln2"], cfg.norm_eps)
        with use_mesh(local_mesh(*EP_MESH, DEV, stats=stats)):
            got = moe.moe_apply(c, lp["moe"], h2).float()
        want = moe.moe_ref(c, lp["moe"], h2).float()
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    drops = [d.tolist() for d in stats.dropped]
    check(drops == [[0] * EP_MESH[1]] and err <= 4 * 2.0 ** -8 * scale,
          f"phase 28: layer 0's MoE at capacity factor {EP_CHECK_CF} "
          f"(drops {drops}) differs from moe_ref by {err:.4g}, max|y| "
          f"{scale:.4g}, bound {4 * 2.0 ** -8 * scale:.4g}")
    return err / scale


def ep_decode_check(cfg, params, one) -> dict:
    """Phase 28 check 3: the replicated decode path against the all-to-all
    prefill on the one-process mesh, at positions 0 to ``EP_DECODE - 1``.

    The decode steps are held to a prefill with the plain attention
    (``use_kernel=False``; its own drops recorded), within the serve
    phases' bound of layers x 2^-8 of max|logit|, on the rows none of whose
    first ``EP_DECODE`` tokens lost a pair in any layer (a lost pair is
    another function: the decode path drops nothing; shard 0 holds
    positions [0, S / 2) of every row). Against the served prefill (the
    flash kernel's rounding) they are printed, not held: with random
    weights the router's 64 gates are near ties, and a rounding apart
    flips a token's top 6 and then its later positions' logits. The same
    weights without a mesh (``moe_ref``: a prefill with the kernel, then
    the decode steps) are the witness: the EP decode's distance from the
    served prefill may be at most ``EP_SERVED_DIFF_RATIO`` times the
    witness's max |diff|, and its top-1 agreement at most
    ``EP_SERVED_TOP1_MARGIN`` below the witness's."""
    import torch
    from repro_torch.configs import ShapeCell
    from repro_torch.distributed import MeshStats, local_mesh
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import make_serve_fns
    from repro_torch.models import build_model
    n = cfg.n_layers
    model = build_model(cfg)
    cell = ShapeCell("ep", EP_PROMPT, EP_BATCH, "prefill")
    prompts, dec = one["prompts"], one["decode"].float()
    stats = MeshStats()
    plain_prefill, _ = make_serve_fns(
        model, local_mesh(*EP_MESH, DEV, stats=stats), cell)
    w_prefill, w_decode = make_serve_fns(model, None, cell)
    before = (ops.flash_attention.launches, ops.flash_attention.tc_launches)
    with torch.inference_mode():
        plain = plain_prefill(params, {"tokens": prompts})
        plain = plain[:, :EP_DECODE].float().transpose(0, 1)   # [16, B, V]
        w_pre = w_prefill(params, {"tokens": prompts}, use_kernel=True)
        w_pre = w_pre[:, :EP_DECODE].float().transpose(0, 1)
        state = model.init_decode_state(EP_BATCH, EP_PROMPT, DEV)
        w_dec = []
        for i in range(EP_DECODE):
            lg, state = w_decode(params, state, {"token": prompts[:, i]})
            w_dec.append(lg)
        w_dec = torch.stack(w_dec).float()
    torch.cuda.synchronize()
    ops.flash_attention.launches, ops.flash_attention.tc_launches = before
    s_loc = EP_PROMPT // EP_MESH[1]
    hit = torch.zeros(EP_BATCH, dtype=torch.bool)
    for lost in stats.lost:
        hit |= lost[0].cpu().view(EP_BATCH, s_loc)[:, :EP_DECODE].any(1)
    rows = [r for r in range(EP_BATCH) if not hit[r]]
    scale = float(plain.abs().max())
    bound = n * 2.0 ** -8 * scale
    diff = float((plain[:, rows] - dec[:, rows]).abs().max()) if rows \
        else -1.0
    kern = one["logits"][:, :EP_DECODE].float().transpose(0, 1)

    def apart(a, b):
        return (float((a - b).abs().max()),
                float((a.argmax(-1) == b.argmax(-1)).float().mean()))

    k_diff, k_top1 = apart(kern, dec)
    w_diff, w_top1 = apart(w_pre, w_dec)
    print(f"phase 28 decode vs the plain-attention prefill at positions "
          f"0-{EP_DECODE - 1}: max |diff| {diff:.4g} on rows {rows} (bound "
          f"{bound:.4g}, {n} x 2^-8 of max|logit| {scale:.4g}); vs the "
          f"served prefill (flash kernel) {k_diff:.4g}, top-1 agreement "
          f"{k_top1:.3f}; the witness without a mesh (moe_ref, kernel "
          f"prefill vs decode) {w_diff:.4g}, top-1 {w_top1:.3f}",
          flush=True)
    check(rows and diff <= bound, f"phase 28: decode logits differ from "
          f"the plain prefill's by {diff:.4g} on rows {rows}, bound "
          f"{bound:.4g}")
    check(k_diff <= EP_SERVED_DIFF_RATIO * w_diff
          and k_top1 >= w_top1 - EP_SERVED_TOP1_MARGIN,
          f"phase 28: the EP decode is further from the served prefill "
          f"({k_diff:.4g}, top-1 {k_top1:.3f}) than the witness without a "
          f"mesh allows ({w_diff:.4g} x {EP_SERVED_DIFF_RATIO}, top-1 "
          f"{w_top1:.3f} - {EP_SERVED_TOP1_MARGIN})")
    return dict(decode_vs_plain_prefill=diff, rows=rows,
                decode_vs_kernel_prefill=k_diff, kernel_top1=k_top1,
                witness_diff=w_diff, witness_top1=w_top1)


def ep_slice(card_line):
    """Phase 28: expert-parallel serving, one process against two gloo
    ranks sharing the card. Returns the flash launches of its prefills."""
    import torch
    from repro_torch.distributed import MeshStats, fsdp, local_mesh
    from repro_torch.models import build_model
    cfg = zoo_config(EP_ARCH, EP_LAYERS)
    n, e = cfg.n_layers, cfg.moe.num_experts
    model = build_model(cfg)
    count = model.param_count()
    per_rank = fsdp.shard_bytes(model, local_mesh(*EP_MESH, DEV))[
        "params"] // 2
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    mesh = local_mesh(*EP_MESH, DEV, stats=MeshStats())
    params = model.init(torch.Generator(DEV).manual_seed(EP_SEED), DEV)
    one = ep_serve(cfg, mesh, params)
    t1 = time.perf_counter()
    # the one process launches the kernel on each model shard's heads
    want = dict.fromkeys(one["counts"], 0)
    want["flash_attention.launches"] = want["flash_attention.tc_launches"] \
        = n * EP_MESH[0] * EP_MESH[1]
    check(one["counts"] == want, f"phase 28: one process's launches "
          f"{one['counts']}, want {want}")
    want_rank = dict(want)
    want_rank["flash_attention.launches"] = \
        want_rank["flash_attention.tc_launches"] = n
    logits, dec = one["logits"], one["decode"]
    v = cfg.vocab
    check(tuple(logits.shape) == (EP_BATCH, EP_PROMPT, v)
          and tuple(dec.shape) == (EP_DECODE, EP_BATCH, v)
          and bool(torch.isfinite(logits).all())
          and bool(torch.isfinite(dec).all()),
          f"phase 28: prefill logits {tuple(logits.shape)}, decode "
          f"{tuple(dec.shape)}, or not finite")
    check(len(one["dropped"]) == n, f"phase 28: {len(one['dropped'])} "
          f"all-to-all layers recorded, want {n}")
    check3 = ep_decode_check(cfg, params, one)
    layer_rel = ep_layer_check(cfg, params, one["prompts"])
    one_digests = (digest(logits), [digest(t) for t in dec])
    one_peak = one["peak_gb"]
    del params, logits, dec
    for key in ("logits", "decode", "prompts"):
        del one[key]
    gc.collect()
    torch.cuda.empty_cache()
    t2 = time.perf_counter()
    ranks, seconds = launch_ranks("phase 28", EP_MESH[0] * EP_MESH[1], [],
                                  EP_LAYERS, arch=EP_ARCH, ep=True)
    for r in ranks:
        m = r["coords"][1]
        tag = f"phase 28 rank {r['rank']}"
        check(r["logits"] == one_digests[0] and r["decode"] == one_digests[1],
              f"{tag}: logits differ from the one process's")
        check(r["dropped"] == [[layer[m]] for layer in one["dropped"]],
              f"{tag}: drops {r['dropped']} differ from the one process's "
              f"shard {m}")
        check(r["counts"] == want_rank, f"{tag}: launches {r['counts']}, "
              f"want {want_rank}")
        check(r["experts"] == e // EP_MESH[1]
              and r["heads"] == cfg.n_heads // EP_MESH[1]
              and r["param_bytes"] == r["reckoned"], f"{tag}: holds "
              f"{r['experts']} experts, {r['heads']} heads, "
              f"{r['param_bytes']} parameter bytes; want "
              f"{e // EP_MESH[1]}, {cfg.n_heads // EP_MESH[1]}, its shards' "
              f"{r['reckoned']}")
    s_loc = EP_PROMPT // EP_MESH[1]
    print(f"phase 28 drops by layer (shard 0, shard 1 of "
          f"{EP_BATCH * s_loc * cfg.moe.top_k} pairs each): "
          f"{one['dropped']}", flush=True)
    print(f"phase 28 one process: {n} layers at full width "
          f"({count / 1e9:.2f} B parameters, {2 * count / 1e9:.2f} GB in "
          f"bf16; reckoned 7.5 B, 15 GB), peak {one_peak:.2f} GB; prefill "
          f"{one['prefill_ms']:.2f} ms, decode {one['decode_ms']:.3f} ms a "
          f"token, all-to-all (a transpose here) {one['a2a_s']:.4f} s in "
          f"{one['a2a_calls']} calls; flash launches "
          f"{one['counts']['flash_attention.launches']}; layer 0's MoE at "
          f"cf {EP_CHECK_CF} vs moe_ref {layer_rel:.4g} of max|y| "
          f"[{card_line}]", flush=True)
    for r in ranks:
        print(f"phase 28 rank {r['rank']} {tuple(r['coords'])} on "
              f"{r['device']}: {r['experts']} experts and {r['heads']} "
              f"heads ({per_rank / 1e9:.2f} B parameters, "
              f"{2 * per_rank / 1e9:.2f} GB reckoned; "
              f"{r['params_gb']:.2f} GB allocated after the draw, peak "
              f"{r['init_peak_gb']:.2f} GB while drawing); serving peak "
              f"{r['peak_gb']:.2f} GB against the one process's "
              f"{one_peak:.2f} GB; prefill {r['prefill_ms']:.2f} ms, decode "
              f"{r['decode_ms']:.3f} ms a token, all-to-all "
              f"{r['a2a_s']:.4f} s in {r['a2a_calls']} calls (staged "
              f"gloo); flash launches "
              f"{r['counts']['flash_attention.launches']}; gloo "
              f"all_to_all_single on CUDA tensors: {r['probe']} "
              f"[{card_line}]", flush=True)
    print("phase 28: NCCL's all-to-all (a card a rank) has not run: the "
          "ranks share one card, over gloo", flush=True)
    print(f"phase 28: one process {t1 - t0:.1f} s, checks "
          f"{t2 - t1:.1f} s, ranks {seconds:.1f} s", flush=True)
    return dict(launches=want["flash_attention.launches"]
                + sum(r["counts"]["flash_attention.launches"]
                      for r in ranks),
                one_process=dict(prefill_ms=one["prefill_ms"],
                                 decode_ms=one["decode_ms"],
                                 peak_gb=one_peak, dropped=one["dropped"],
                                 **check3),
                ranks=[{k: r[k] for k in ("prefill_ms", "decode_ms", "a2a_s",
                                          "peak_gb", "probe")}
                       for r in ranks])


# phase 29: the in-pod sharded local step (distributed.fsdp) of
# moonshot-v1-16b-a3b at full width, 1 of 48 layers, bf16, on 4 gloo ranks
# sharing the card: (a) make_train_fns on data 2 x model 2, (b) the
# consensus trainer, J 2 ring, data 1 x model 2 a node, shard_consensus
INPOD_ARCH = "moonshot-v1-16b-a3b"
INPOD_LAYERS = 1
INPOD_TRAIN_MESH = (2, 2)
INPOD_BATCH, INPOD_SEQ = 4, 512
INPOD_TRAIN_STEPS = 2
INPOD_CONS_MESH = (1, 2)
INPOD_NODES = 2
# 29b's batch a node: 4 x 256 tokens, so that four ranks' round and probe
# transients fit the card beside each other (PERF.md)
INPOD_CONS_SEQ = 256
INPOD_CONS_STEPS, INPOD_LOCAL = 2, 2     # one round, for the script's time
INPOD_SEED = 29
INPOD_LR = 3e-4


def inpod_batch(cfg, step):
    """29a's global batch of ``step``: seeded tokens [4, 512] and their
    next tokens as labels (the same on every rank)."""
    import torch
    g = torch.Generator(DEV).manual_seed(INPOD_SEED * 1000 + step)
    toks = torch.randint(0, cfg.vocab, (INPOD_BATCH, INPOD_SEQ + 1),
                         generator=g, device=DEV)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def spec_leaves(specs):
    from repro_torch import tree as tree_lib
    return tree_lib.leaves(specs, is_leaf=lambda v: isinstance(v, tuple))


def shard_digests(tree, specs, mesh, coords=None):
    """Digests of the leaves of a rank's shards (``coords`` None), or of
    rank ``coords``' blocks of a whole tree."""
    from repro_torch import tree as tree_lib
    from repro_torch.distributed import fsdp
    out = []
    for x, s in zip(tree_lib.leaves(tree), spec_leaves(specs), strict=True):
        if coords is not None:
            x = fsdp.shard_of(x, s, mesh, coords).contiguous()
        out.append(digest(x))
    return out


def tree_bytes(*trees) -> int:
    from repro_torch import tree as tree_lib
    return sum(x.numel() * x.element_size() for t in trees
               for x in tree_lib.leaves(t))


def pinned_bytes(staging) -> int:
    """The bytes of a ``HostStaging`` pair (0 without one)."""
    if staging is None:
        return 0
    return staging.send.numel() + staging.recv.numel()


def host_gb() -> tuple[float, float]:
    """This process's resident host memory now (``VmRSS``) and at its
    peak (``getrusage``'s ``ru_maxrss``), GB; pinned staging buffers count
    in both."""
    import resource
    now = 0.0
    with open("/proc/self/status") as f:
        for ln in f:
            if ln.startswith("VmRSS:"):
                now = int(ln.split()[1]) * 1024 / 1e9
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9
    return now, peak


def reckon_inpod_peak(cfg, mesh, rows, seq, total=None,
                      whole_rows=False) -> dict:
    """Phase 29's peak device bytes a rank, reckoned from the code before
    the run (PERF.md). Resident: the shards' bf16 parameters and f32
    AdamW moments (``fsdp.shard_bytes``) and, in a consensus run, the f32
    lam and theta_bar_prev slabs (8 B an element of [1, total / S]). The
    local step's transient: the bf16 gradient shards; the embedding and LM
    head gathered whole and the head's whole gradient (4 x 2 B x vocab x
    d); this model rank's experts of the layer gathered and their gradient
    (2 x 2 B); three f32 logit-sized tensors of its rows. The round's
    (29b): the larger of the pack (the whole tree gathered and the packed
    row, 2 x 2 B an element) and the probes (the own slab and the received
    one, 2 B an element of [1, total / S] each; the gathered payload, 2 B
    an element; three f32 logit-sized tensors). ``whole`` is the replicated
    layout: the node's parameters and moments whole on every rank (10 B a
    parameter), with the same slabs and transients besides.

    A dense arch gathers a whole layer instead of its experts (2 x 2 B a
    parameter of the layer). With ``whole_rows`` (phase 30, the flat rows
    replicated in-pod) each rank holds the whole f32 lam and
    theta_bar_prev rows (8 B an element of [1, total]), and the round's
    probes hold the whole packed row and the received one (2 B an element
    each: a native payload is a view of it) beside the logits."""
    from repro_torch.distributed import fsdp
    from repro_torch.models import build_model
    model = build_model(cfg)
    n = model.param_count()
    sb = fsdp.shard_bytes(model, mesh)
    logits = 3 * 4 * rows * seq * cfg.vocab
    if cfg.moe is not None:
        experts = cfg.n_layers * 3 * cfg.moe.num_experts * cfg.d_model \
            * cfg.moe.expert_d_ff
        gathered = experts // (cfg.n_layers * mesh.model)
    else:
        gathered = (n - 2 * cfg.vocab * cfg.d_model) // cfg.n_layers
    local = sb["params"] + 4 * 2 * cfg.vocab * cfg.d_model \
        + 2 * 2 * gathered + logits
    rnd, slabs = 0, 0
    if total is not None and whole_rows:
        slabs = 8 * total
        rnd = max(2 * 2 * total, 2 * 2 * total + logits)
    elif total is not None:
        slabs = 8 * (total // mesh.size)
        rnd = max(2 * 2 * total,
                  2 * 2 * (total // mesh.size) + 2 * total + logits)
    resident = sb["total"] + slabs
    return dict(resident=resident, local=local, round=rnd,
                peak=resident + max(local, rnd),
                whole=10 * n + slabs + max(local, rnd))


def inpod_train(cfg, mesh):
    """29a on ``mesh`` (the one-process mesh, or a rank's): ``make_train_fns``
    drawn from the seed, ``INPOD_TRAIN_STEPS`` steps of ``inpod_batch``.
    With ``mesh.stats`` None nothing synchronises inside a step, which is
    timed alone; with stats on, each step's drops by shard and its
    gathers', reduce-scatters' and all-to-alls' seconds (each between two
    synchronisations of the device, which slow the step) are recorded too.
    Returns the losses, grad norms, each step's seconds, the state's bytes
    between steps and the peak, the drops and collectives with stats on,
    and the state."""
    import torch
    from repro_torch.launch.steps import make_train_fns
    from repro_torch.models import build_model
    from repro_torch.optim.adamw import AdamWConfig
    model = build_model(cfg)
    init, step, _, _ = make_train_fns(model, mesh, AdamWConfig(lr=INPOD_LR))
    torch.cuda.reset_peak_memory_stats()
    state = init(torch.Generator(DEV).manual_seed(INPOD_SEED), DEV)
    st = mesh.stats
    out = dict(loss=[], grad_norm=[], dropped=[], seconds=[], coll=[],
               state_bytes=[])
    for s in range(INPOD_TRAIN_STEPS):
        batch = inpod_batch(cfg, s)
        torch.cuda.synchronize()
        out["state_bytes"].append(tree_bytes(state.params, state.opt.m,
                                             state.opt.v))
        if st is not None:
            st.clear()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        out["seconds"].append(time.perf_counter() - t0)
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
        if st is None:
            continue
        # each shard's drops summed over the layers: a rank records its
        # own shard's, the one process every shard's (data index major)
        per = {}
        for n, d in enumerate(st.dropped):
            for k, v in enumerate(d.tolist()):
                coords = (n // cfg.n_layers, k) if mesh.local \
                    else tuple(mesh.coords)
                per[f"{coords[0]}{coords[1]}"] = per.get(
                    f"{coords[0]}{coords[1]}", 0) + v
        out["dropped"].append(per)
        out["coll"].append(coll_seconds(st))
    torch.cuda.synchronize()
    out["state_bytes"].append(tree_bytes(state.params, state.opt.m,
                                         state.opt.v))
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["state"] = state
    return out


def coll_seconds(st) -> dict:
    """A ``MeshStats``' seconds and calls of each kind of collective."""
    out = {}
    for k, v in st.seconds.items():
        out[f"{k}_s"], out[f"{k}_calls"] = v, st.calls[k]
    return out


def inpod_timed_train(cfg, mesh):
    """29a on a rank's ``mesh`` (its stats on): once with the stats, for
    the drops and the collectives' seconds, then again from the same seed
    with none, timed; the two runs' losses and grad norms must be equal.
    Returns the timed run's numbers and state, with the instrumented run's
    drops, collectives and step seconds."""
    import torch
    inst = inpod_train(cfg, mesh)
    del inst["state"]
    gc.collect()
    torch.cuda.empty_cache()
    out = inpod_train(cfg, dataclasses.replace(mesh, stats=None))
    check(out["loss"] == inst["loss"]
          and out["grad_norm"] == inst["grad_norm"],
          f"phase 29a rank {mesh.coords}: the timed run's losses "
          f"{out['loss']} / grad norms {out['grad_norm']} differ from the "
          f"instrumented run's {inst['loss']} / {inst['grad_norm']}")
    out.update(dropped=inst["dropped"], coll=inst["coll"],
               instrumented_s=inst["seconds"])
    return out


def inpod_trainer(cfg, grid):
    """29b's consensus trainer on ``grid``, its data source and its state
    drawn from the seed (the device's cache emptied after)."""
    import torch
    from repro_torch.core.penalty import PenaltyConfig
    from repro_torch.data import DataConfig, SyntheticTokens
    from repro_torch.models import build_model
    from repro_torch.optim import ConsensusConfig, ConsensusTrainer
    from repro_torch.optim.adamw import AdamWConfig
    model = build_model(cfg)
    tr = ConsensusTrainer(
        model, num_nodes=INPOD_NODES, device=grid.device,
        adamw=AdamWConfig(lr=INPOD_LR), ranks=grid,
        consensus=ConsensusConfig(
            penalty=PenaltyConfig(scheme="nap", eta0=0.1), topology="ring",
            local_steps=INPOD_LOCAL, wire_codec="native",
            shard_consensus=True))
    data = SyntheticTokens(DataConfig(
        vocab=cfg.vocab, seq_len=INPOD_CONS_SEQ, batch_per_node=4,
        num_nodes=INPOD_NODES, seed=INPOD_SEED), device=DEV,
        nodes=(grid.node_lo, grid.node_hi))
    params = model.init(torch.Generator(DEV).manual_seed(INPOD_SEED), DEV)
    state = tr.init_state(params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return tr, data, state


def inpod_cons_stats(cfg, grid):
    """29b's first local step on a rank's ``grid``, with its mesh's stats
    on: the in-pod gathers', reduce-scatters' and all-to-alls' seconds
    (each between two synchronisations of the device) and the step's
    seconds and loss, which must equal the timed run's."""
    import torch
    from repro_torch.distributed import MeshStats
    stats = MeshStats()
    grid = dataclasses.replace(grid, mesh=dataclasses.replace(
        grid.mesh, stats=stats))
    tr, data, state = inpod_trainer(cfg, grid)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, m = tr.train_step(state, data.batch(0))
    torch.cuda.synchronize()
    out = dict(seconds=time.perf_counter() - t0, loss=float(m["loss"]),
               coll=coll_seconds(stats))
    del tr, data, state
    gc.collect()
    torch.cuda.empty_cache()
    return out


def inpod_cons(cfg, grid):
    """29b on ``grid`` (``trivial_grid(2, shards=2, mesh=(1, 2))`` or a
    rank's, with no stats): the consensus trainer, J 2 ring, nap, native
    wire, 4 steps of 4 x ``INPOD_CONS_SEQ`` tokens a node with a round
    after every second, every counter from 0 first. Each step and round
    timed between two synchronisations (nothing synchronises inside); the
    round kernel's device time by CUDA events hooked on its launch.
    Returns the metrics, seconds, launches and the state."""
    import torch
    from repro_torch.kernels import ops
    torch.cuda.reset_peak_memory_stats()
    tr, data, state = inpod_trainer(cfg, grid)
    launch, timed = ops._cu.launch, []

    def timed_launch(theta, lam, bar_prev, wires, scales, e_sym, *rest,
                     **kw):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        bound = round_bound(theta, lam, bar_prev, wires, scales, e_sym,
                            rest[3])[0]
        a.record()
        res = launch(theta, lam, bar_prev, wires, scales, e_sym, *rest, **kw)
        b.record()
        timed.append((a, b, bound))
        return res

    for obj, attr in all_counters():
        setattr(obj, attr, 0)
    out = dict(loss=[], r_max=[], eta=[], step_s=[], round_s=[],
               state_bytes=[])
    ops._cu.launch = timed_launch
    try:
        for s in range(INPOD_CONS_STEPS):
            torch.cuda.synchronize()
            out["state_bytes"].append(tree_bytes(state.params, state.opt.m,
                                                 state.opt.v))
            t0 = time.perf_counter()
            state, m = tr.train_step(state, data.batch(s))
            torch.cuda.synchronize()
            out["step_s"].append(time.perf_counter() - t0)
            out["loss"].append(float(m["loss"]))
            if tr.should_sync(s):
                t0 = time.perf_counter()
                state, cm = tr.consensus_step(state,
                                              data.batch(10**6 + s))
                torch.cuda.synchronize()
                out["round_s"].append(time.perf_counter() - t0)
                out["r_max"].append(float(cm["r_max"]))
                out["eta"].append(float(cm["eta_mean"]))
    finally:
        ops._cu.launch = launch
    torch.cuda.synchronize()
    out["counts"] = {f"{obj.__name__}.{attr}": getattr(obj, attr)
                     for obj, attr in all_counters()}
    out["kernel_ms"] = [a.elapsed_time(b) for a, b, _ in timed]
    out["bound_ms"] = timed[0][2] if timed else None
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["total"] = tr.layout.total
    out["state"], out["trainer"] = state, tr
    return out


def inpod_worker(spec, cfg, rank, out_dir) -> int:
    """One rank of phase 29 (``chip_smoke.py --ranks-worker SPEC`` with
    ``"inpod"`` in the spec): 29a on its data 2 x model 2 mesh
    (``init_mesh``, gloo on the card), then 29b on the same 4 ranks
    (``init_ranks`` with ``mesh=(1, 2)``: pod ``r // 2``); its digests and
    numbers into ``rank<r>.json``."""
    import torch
    from repro_torch import tree as tree_lib
    from repro_torch.distributed import MeshStats, fsdp
    from repro_torch.distributed.exchange import empty_host_cache
    from repro_torch.launch.mesh import init_mesh, init_ranks
    from repro_torch.models import build_model
    mesh = init_mesh(*INPOD_TRAIN_MESH, DEV, backend="gloo",
                     stats=MeshStats())
    a = inpod_timed_train(cfg, mesh)
    specs, _ = fsdp.specs_for(build_model(cfg), mesh)
    st = a.pop("state")
    a.update(coords=list(mesh.coords),
             params=shard_digests(st.params, specs, mesh),
             m=shard_digests(st.opt.m, specs, mesh),
             v=shard_digests(st.opt.v, specs, mesh),
             reckoned=fsdp.shard_bytes(build_model(cfg), mesh)["total"],
             staging=pinned_bytes(mesh.staging), host_gb=host_gb())
    # 29b runs on the same process group: let go of 29a's mesh and its
    # pinned staging first
    del st, mesh
    gc.collect()
    torch.cuda.empty_cache()
    empty_host_cache()
    grid = init_ranks(INPOD_NODES, DEV, backend="gloo", shard_consensus=True,
                      mesh=INPOD_CONS_MESH)
    try:
        probe = inpod_cons_stats(cfg, grid)
        b = inpod_cons(cfg, grid)
        check(b["loss"][0] == probe["loss"], f"phase 29b rank {rank}: the "
              f"timed run's first loss {b['loss'][0]} differs from the "
              f"instrumented step's {probe['loss']}")
        b.update(coll=probe["coll"], instrumented_s=probe["seconds"])
        st, tr = b.pop("state"), b.pop("trainer")
        first = lambda t: tree_lib.tree_map(lambda x: x[0], t)
        b.update(pod=grid.pod, shard=grid.shard,
                 coords=list(grid.mesh.coords),
                 params=shard_digests(first(st.params), tr.specs, grid.mesh),
                 m=shard_digests(first(st.opt.m), tr.specs, grid.mesh),
                 lam=digest(st.lam[0]), bar=digest(st.theta_bar_prev[0]),
                 eta_digest=digest(st.penalty.eta),
                 reckoned=fsdp.shard_bytes(build_model(cfg),
                                           grid.mesh)["total"],
                 staging=tr.staging_bytes()
                 + pinned_bytes(grid.mesh.staging), host_gb=host_gb())
        del st, tr
    finally:
        grid.close()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump({"rank": rank, "a": a, "b": b}, f)
    return 0


def inpod_slice(card_line):
    """Phase 29: the in-pod sharded local step, one process against 4 gloo
    ranks sharing the card, (a) through ``make_train_fns`` and (b) through
    the consensus trainer. Returns the round kernel's launches and times."""
    import torch
    from repro_torch import tree as tree_lib
    from repro_torch.distributed import (MeshStats, fsdp, local_mesh,
                                         trivial_grid)
    from repro_torch.distributed.exchange import empty_host_cache
    from repro_torch.models import build_model
    cfg = zoo_config(INPOD_ARCH, INPOD_LAYERS)
    model = build_model(cfg)
    count = model.param_count()
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    mesh_a = local_mesh(*INPOD_TRAIN_MESH, DEV, stats=MeshStats())
    a = inpod_train(cfg, mesh_a)
    specs_a, _ = fsdp.specs_for(model, mesh_a)
    st = a.pop("state")
    want_a = {c: {name: shard_digests(t, specs_a, mesh_a, c) for name, t in
                  (("params", st.params), ("m", st.opt.m),
                   ("v", st.opt.v))} for c in mesh_a.all_coords()}
    del st
    gc.collect()
    torch.cuda.empty_cache()
    check(all(map(math.isfinite, a["loss"] + a["grad_norm"])),
          f"phase 29a: losses {a['loss']}, grad norms {a['grad_norm']}")
    t1 = time.perf_counter()
    b = inpod_cons(cfg, trivial_grid(INPOD_NODES, DEV,
                                     mesh=INPOD_CONS_MESH))
    st, tr = b.pop("state"), b.pop("trainer")
    n_rounds = INPOD_CONS_STEPS // INPOD_LOCAL
    want_counts = dict.fromkeys(b["counts"], 0)
    want_counts["consensus_round.launches"] = n_rounds
    check(b["counts"] == want_counts, f"phase 29b: one process's launches "
          f"{b['counts']}, want {want_counts}")
    check(all(map(math.isfinite, b["loss"] + b["r_max"] + b["eta"])),
          f"phase 29b: losses {b['loss']}, r_max {b['r_max']}, eta "
          f"{b['eta']}")
    gm, s_n = tr.mesh, tr.mesh.size
    want_b = {}
    for pod in range(INPOD_NODES):
        node = {name: tree_lib.tree_map(lambda x: x[pod], t)
                for name, t in (("params", st.params), ("m", st.opt.m))}
        for sh in range(s_n):
            cols = tr.slayout.columns(sh)
            want_b[(pod, sh)] = dict(
                {name: shard_digests(t, tr.specs, gm, divmod(sh, gm.model))
                 for name, t in node.items()},
                lam=digest(st.lam[pod, cols]),
                bar=digest(st.theta_bar_prev[pod, cols]))
    eta_digest = digest(st.penalty.eta)
    total = b["total"]
    del st, tr, node
    gc.collect()
    torch.cuda.empty_cache()
    # the earlier phases' pinned host buffers stay cached by PyTorch's host
    # allocator (phase 18's 28 GB among them): give them back before four
    # ranks stage through pinned memory of their own
    host_before = host_gb()
    empty_host_cache()
    host_after = host_gb()
    t2 = time.perf_counter()
    world = INPOD_TRAIN_MESH[0] * INPOD_TRAIN_MESH[1]
    ranks, seconds = yield ("phase 29", world, [], INPOD_LAYERS,
                            dict(arch=INPOD_ARCH, inpod=True))
    rank_mesh_a = local_mesh(*INPOD_TRAIN_MESH, DEV)
    rank_mesh_b = local_mesh(*INPOD_CONS_MESH, DEV)
    reck_a = reckon_inpod_peak(cfg, rank_mesh_a,
                               INPOD_BATCH // INPOD_TRAIN_MESH[0], INPOD_SEQ)
    reck_b = reckon_inpod_peak(cfg, rank_mesh_b, 4, INPOD_CONS_SEQ, total)
    for r in ranks:
        ra, rb = r["a"], r["b"]
        c = tuple(ra["coords"])
        tag = f"phase 29a rank {r['rank']} {c}"
        check(ra["loss"] == a["loss"] and ra["grad_norm"] == a["grad_norm"],
              f"{tag}: losses {ra['loss']} / grad norms {ra['grad_norm']} "
              f"differ from the one process's {a['loss']} / "
              f"{a['grad_norm']}")
        for name in ("params", "m", "v"):
            check(ra[name] == want_a[c][name], f"{tag}: {name} digests "
                  "differ from the one process's")
        key = f"{c[0]}{c[1]}"
        check([d[key] for d in ra["dropped"]] ==
              [d[key] for d in a["dropped"]],
              f"{tag}: drops {ra['dropped']} differ from the one process's "
              f"{a['dropped']}")
        check(len(set(ra["state_bytes"])) == 1
              and ra["state_bytes"][0] == ra["reckoned"],
              f"{tag}: parameter and moment bytes {ra['state_bytes']}, "
              f"reckoned {ra['reckoned']}")
        tag = f"phase 29b rank {r['rank']} (pod {rb['pod']}, slab " \
              f"{rb['shard']})"
        for name in ("loss", "r_max", "eta"):
            check(rb[name] == b[name], f"{tag}: {name} {rb[name]} differ "
                  f"from the one process's {b[name]}")
        w = want_b[(rb["pod"], rb["shard"])]
        for name in ("params", "m", "lam", "bar"):
            check(rb[name] == w[name], f"{tag}: {name} digests differ from "
                  "the one process's")
        check(rb["eta_digest"] == eta_digest, f"{tag}: eta differs")
        want_r = dict.fromkeys(rb["counts"], 0)
        want_r["consensus_round.launches"] = n_rounds
        check(rb["counts"] == want_r, f"{tag}: launches {rb['counts']}, "
              f"want {want_r}")
        check(len(set(rb["state_bytes"])) == 1
              and rb["state_bytes"][0] == rb["reckoned"],
              f"{tag}: parameter and moment bytes {rb['state_bytes']}, "
              f"reckoned {rb['reckoned']}")
    gb = 1e9
    print(f"phase 29: moonshot-v1-16b-a3b at full width, {cfg.n_layers} "
          f"layer, {count / 1e9:.3f} B parameters a node, bf16; "
          f"{t2 - t0 + seconds:.1f} s (one process 29a {t1 - t0:.1f} s, "
          f"29b {t2 - t1:.1f} s, ranks {seconds:.1f} s in a torchrun call "
          f"shared with phases 26 and 30a) [{card_line}]", flush=True)
    print(f"phase 29a one process (local_mesh{INPOD_TRAIN_MESH}): losses "
          f"{a['loss']}, grad norms {a['grad_norm']}, drops by step and "
          f"shard {a['dropped']} (of {INPOD_BATCH // INPOD_TRAIN_MESH[0] * INPOD_SEQ // INPOD_TRAIN_MESH[1] * cfg.moe.top_k} "
          f"pairs a shard a layer), steps (stats on) "
          + " ".join(f"{x:.3f}" for x in a["seconds"])
          + f" s, state {a['state_bytes'][0] / gb:.2f} GB, peak "
          f"{a['peak_gb']:.2f} GB [{card_line}]", flush=True)
    for r in ranks:
        ra = r["a"]
        print(f"phase 29a rank {r['rank']} {tuple(ra['coords'])}: state "
              f"{ra['state_bytes'][0] / gb:.3f} GB (reckoned "
              f"{ra['reckoned'] / gb:.3f}; whole on every rank: "
              f"{10 * count / gb:.2f}), peak {ra['peak_gb']:.2f} GB "
              f"(reckoned {reck_a['peak'] / gb:.2f}; the replicated layout "
              f"{reck_a['whole'] / gb:.2f}); steps "
              + " ".join(f"{x:.3f}" for x in ra["seconds"])
              + " s (with stats on "
              + " ".join(f"{x:.3f}" for x in ra["instrumented_s"])
              + " s); with stats on, a step's gathers "
              + " ".join(f"{x['gather_s']:.3f}" for x in ra["coll"])
              + " s, reduce-scatters " + " ".join(
                  f"{x['rs_s']:.3f}" for x in ra["coll"])
              + " s, all-to-alls " + " ".join(
                  f"{x['a2a_s']:.3f}" for x in ra["coll"])
              + f" s (calls {ra['coll'][0]['gather_calls']}, "
              f"{ra['coll'][0]['rs_calls']}, {ra['coll'][0]['a2a_calls']}; "
              f"staged gloo, synchronized) [{card_line}]", flush=True)
    print(f"phase 29b one process (trivial_grid({INPOD_NODES}, "
          f"mesh={INPOD_CONS_MESH})): losses {b['loss']}, r_max "
          f"{b['r_max']}, eta {b['eta']}; steps "
          + " ".join(f"{x:.3f}" for x in b["step_s"]) + " s, rounds "
          + " ".join(f"{x:.3f}" for x in b["round_s"])
          + " s; consensus_round " + " ".join(
              f"{x:.3f}" for x in b["kernel_ms"])
          + f" ms, bound {b['bound_ms']:.3f} ms; peak {b['peak_gb']:.2f} GB "
          f"[{card_line}]", flush=True)
    for r in ranks:
        rb = r["b"]
        print(f"phase 29b rank {r['rank']} (pod {rb['pod']}, slab "
              f"{rb['shard']}, {tuple(rb['coords'])}): state "
              f"{rb['state_bytes'][0] / gb:.3f} GB (reckoned "
              f"{rb['reckoned'] / gb:.3f}; the replicated layout "
              f"{10 * count / gb:.2f}), slabs "
              f"{8 * (total // 2) / gb:.3f} GB, peak {rb['peak_gb']:.2f} GB "
              f"(reckoned {reck_b['peak'] / gb:.2f}; the replicated layout "
              f"{reck_b['whole'] / gb:.2f}); steps "
              + " ".join(f"{x:.3f}" for x in rb["step_s"]) + " s, rounds "
              + " ".join(f"{x:.3f}" for x in rb["round_s"])
              + f" s; its first step again with stats on "
              f"{rb['instrumented_s']:.3f} s: gathers "
              f"{rb['coll']['gather_s']:.3f} s, reduce-scatters "
              f"{rb['coll']['rs_s']:.3f} s, all-to-alls "
              f"{rb['coll']['a2a_s']:.3f} s (calls "
              f"{rb['coll']['gather_calls']}, {rb['coll']['rs_calls']}, "
              f"{rb['coll']['a2a_calls']}; staged gloo, synchronized)"
              + "; consensus_round " + " ".join(
                  f"{x:.3f}" for x in rb["kernel_ms"])
              + f" ms (bound {rb['bound_ms']:.3f} ms); pinned staging "
              f"{rb['staging'] / gb:.2f} GB [{card_line}]", flush=True)
    print(f"phase 29 host memory: the main process {host_before[0]:.2f} GB "
          f"resident before releasing the cached pinned blocks, "
          f"{host_after[0]:.2f} after (peak so far {host_after[1]:.2f}); "
          "the ranks' peaks " + " ".join(
              f"{max(r['a']['host_gb'][1], r['b']['host_gb'][1]):.2f}"
              for r in ranks) + " GB, their pinned staging after 29a "
          + " ".join(f"{r['a']['staging'] / 1e9:.2f}" for r in ranks)
          + " GB and after 29b " + " ".join(
              f"{r['b']['staging'] / 1e9:.2f}" for r in ranks) + " GB",
          flush=True)
    print("phase 29: NCCL across cards has not run: the ranks share one "
          "card, over gloo", flush=True)
    rank_ms = [x for r in ranks for x in r["b"]["kernel_ms"]]
    return dict(launches=n_rounds + sum(
        r["b"]["counts"]["consensus_round.launches"] for r in ranks),
        one_process_ms=float(np.median(b["kernel_ms"])),
        one_process_bound_ms=b["bound_ms"],
        rank_ms=float(np.median(rank_ms)),
        rank_bound_ms=ranks[0]["b"]["bound_ms"],
        train_step_s=[r["a"]["seconds"] for r in ranks],
        round_s=[r["b"]["round_s"] for r in ranks],
        peak_gb=[max(r["a"]["peak_gb"], r["b"]["peak_gb"]) for r in ranks])


# phase 30: the reference launcher's own command in the port: the consensus
# state replicated in-pod (stablelm-3b at full width, 2 of 32 layers, J 2 x
# data 1 x model 2 on 4 gloo ranks sharing the card), and checkpoint/resume
REP_ARCH = "stablelm-3b"
REP_LAYERS = 1                  # for the script's time
REP_NODES = 2
REP_MESH = (1, 2)
REP_ARGS = ["--arch", REP_ARCH, "--nodes", str(REP_NODES), "--scheme",
            "nap", "--topology", "ring", "--eta0", "0.1", "--local-steps",
            "2", "--steps", "4", "--batch-per-node", "4", "--seq", "256",
            "--lr", "3e-4", "--wire-codec", "native", "--device", DEV]
REP_CKPT_AT = 2                 # 30b: the first run stops at this step
REP_PEAKS_GB = 64.0             # four ranks' reckoned peaks, at most


def rep_digests(state, specs=None, mesh=None, pod=None, cols=None):
    """Digests of a consensus state's parameter and moment rows (a rank's
    shards, or with ``mesh`` and ``pod`` the one process's node ``pod``
    cut to every in-pod rank's shards), its lam and theta_bar_prev rows
    (whole, or the columns ``cols``) and its replicated eta, mask and
    liveness."""
    from repro_torch import tree as tree_lib
    _, rep = state_digests(state, 0)
    if mesh is None:
        first = lambda t: [digest(x[0]) for x in tree_lib.leaves(t)]
        return dict(params=first(state.params), m=first(state.opt.m),
                    lam=digest(state.lam[0]),
                    bar=digest(state.theta_bar_prev[0]), replicated=rep)
    cols = slice(None) if cols is None else cols
    node = lambda t: tree_lib.tree_map(lambda x: x[pod], t)
    return {"".join(map(str, c)): dict(
        params=shard_digests(node(state.params), specs, mesh, c),
        m=shard_digests(node(state.opt.m), specs, mesh, c))
        for c in mesh.all_coords()} | dict(
        lam=digest(state.lam[pod, cols]),
        bar=digest(state.theta_bar_prev[pod, cols]), replicated=rep)


def rep_run(cfg, args_list, grid):
    """One phase-30 run through ``launch.train.run`` on ``grid``
    (``traced_train``: counters from 0, the kernel's device ms), with this
    rank's digests, numbers and byte counts."""
    import torch
    from repro_torch import tree as tree_lib
    from repro_torch.launch import train as train_lib
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    record, state, ms, _, _ = traced_train(
        cfg, train_lib.parse_args(args_list), grid)
    out = dict(rep_digests(state), rounds=record["rounds"],
               losses=record["losses"], step_s=record["step_seconds"],
               kernel_ms=ms, counts=record["counts"],
               start_step=record["start_step"],
               lam_shape=list(state.lam.shape),
               state_bytes=tree_bytes(state.params, state.opt.m,
                                      state.opt.v)
               + nbytes(state.lam) + nbytes(state.theta_bar_prev),
               peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               total=record["layout"].total,
               block_size=record["layout"].block_size,
               deg=len(record["offsets"]))
    out["shard_bytes"] = tree_bytes(state.params, state.opt.m, state.opt.v)
    del state, record
    gc.collect()
    torch.cuda.empty_cache()
    return out


def rep_worker(spec, cfg, rank, out_dir) -> int:
    """One rank of phase 30 (``chip_smoke.py --ranks-worker SPEC`` with
    ``"rep"`` in the spec). Without ``"resume"``: 30a's replicated run and
    its ``--shard-consensus`` twin, each on its grid over one process
    group, then 30b's run to step ``REP_CKPT_AT`` checkpointing into
    ``spec["ckpt"]``; with it, 30b's fresh run resuming from there to step
    4. The save and restore seconds are the host's around
    ``checkpoint.save_async`` and ``wait_pending`` (the writes, barriers
    and rename) and ``restore``. This rank's results into
    ``rank<r>.json``."""
    from repro_torch import checkpoint
    from repro_torch.distributed.exchange import empty_host_cache
    from repro_torch.launch.mesh import init_ranks
    out = {"rank": rank}
    timed = {"save_async": [], "wait_pending": [], "restore": []}
    saved = {k: getattr(checkpoint, k) for k in timed}

    def timing(name):
        fn = saved[name]

        def call(*a, **kw):
            t0 = time.perf_counter()
            res = fn(*a, **kw)
            timed[name].append(time.perf_counter() - t0)
            return res
        return call
    for k in timed:
        setattr(checkpoint, k, timing(k))
    ckpt = ["--ckpt-dir", spec["ckpt"]]
    # the grids share one process group, which the replicated grid's
    # close() ends
    grid = init_ranks(REP_NODES, DEV, backend="gloo", mesh=REP_MESH)
    try:
        if spec.get("resume"):
            # --ckpt-every past the run: the resumed run saves nothing
            out["resumed"] = rep_run(cfg, REP_ARGS + ckpt + [
                "--ckpt-every", "100"], grid)
        else:
            out["rep"] = rep_run(cfg, REP_ARGS, grid)
            out["pod"], out["coords"] = grid.pod, list(grid.mesh.coords)
            empty_host_cache()
            out["sharded"] = rep_run(cfg, REP_ARGS + ["--shard-consensus"],
                                     init_ranks(REP_NODES, DEV,
                                                backend="gloo",
                                                shard_consensus=True,
                                                mesh=REP_MESH))
            empty_host_cache()
            out["first"] = rep_run(cfg, REP_ARGS + ckpt + [
                "--steps", str(REP_CKPT_AT), "--ckpt-every",
                str(REP_CKPT_AT)], grid)
            step = os.path.join(spec["ckpt"], f"step_{REP_CKPT_AT:010d}")
            mine = [f"leaves.rank{rank:05d}.npz"] + (
                ["leaves.npz", "manifest.msgpack"] if rank == 0 else [])
            out["written"] = sum(os.path.getsize(os.path.join(step, f))
                                 for f in mine)
    finally:
        grid.close()
        for k, fn in saved.items():
            setattr(checkpoint, k, fn)
    out.update(timed=timed, host_gb=host_gb())
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    return 0


def rep_compare(one_rep, one_sh, layouts) -> dict:
    """The replicated and the sharded one-process runs' states: the
    largest |difference| of the parameters, of lam and of theta_bar_prev,
    each unpacked by its run's layout, leaf by leaf."""
    from repro_torch import tree as tree_lib
    out = {"params": 0.0, "lam": 0.0, "bar": 0.0}
    for a, b in zip(tree_lib.leaves(one_rep.params),
                    tree_lib.leaves(one_sh.params), strict=True):
        out["params"] = max(out["params"],
                            float((a.float() - b.float()).abs().max()))
    for key, name in (("lam", "lam"), ("bar", "theta_bar_prev")):
        ua = layouts[0].unpack(getattr(one_rep, name))
        ub = layouts[1].unpack(getattr(one_sh, name))
        for a, b in zip(tree_lib.leaves(ua), tree_lib.leaves(ub),
                        strict=True):
            out[key] = max(out[key], float((a - b).abs().max()))
    return out


def rel_err(a, b) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def replicated_slice(card_line):
    """Phase 30: the reference launcher's command, the consensus state
    replicated in-pod (a) and checkpoint/resume (b), one process against 4
    gloo ranks sharing the card. Returns the round kernel's launches and
    times."""
    import shutil
    import torch
    from repro_torch import resolve_device
    from repro_torch.distributed import fsdp, local_mesh, trivial_grid
    from repro_torch.distributed.exchange import empty_host_cache
    from repro_torch.launch import train as train_lib
    from repro_torch.models import build_model
    from repro_torch.optim import flatten
    t0 = time.perf_counter()
    cfg = zoo_config(REP_ARCH, REP_LAYERS)
    mesh = local_mesh(*REP_MESH, DEV)
    defs = build_model(cfg).param_defs()
    bs = flatten.auto_block_size(defs)
    total = flatten.FlatLayout.for_tree(defs, block_size=bs,
                                        node_axis=False).total
    reck = reckon_inpod_peak(cfg, mesh, 4, 256, total, whole_rows=True)
    check(4 * reck["peak"] <= REP_PEAKS_GB * 1e9, f"phase 30: four ranks' "
          f"reckoned peaks {4 * reck['peak'] / 1e9:.2f} GB pass "
          f"{REP_PEAKS_GB} GB")
    model = build_model(cfg)
    count = model.param_count()
    specs, _ = fsdp.specs_for(model, mesh)
    lay_sh = flatten.FlatLayout.for_tree(defs, block_size=bs,
                                         node_axis=False, shards=2)
    slay = lay_sh.shard(2)
    reck_state = fsdp.shard_bytes(model, mesh)["total"] + 8 * total
    n_rounds = 2
    want_counts = {"launches": n_rounds, "masked_launches": 0,
                   "per_block_launches": 0}
    # (a) one process: the replicated run, then the sharded one
    gc.collect()
    torch.cuda.empty_cache()
    grid = lambda: trivial_grid(REP_NODES, resolve_device(DEV),
                                mesh=REP_MESH)
    runs = {}
    for tag, extra in (("rep", []), ("sharded", ["--shard-consensus"])):
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        record, state, ms, _, _ = traced_train(
            cfg, train_lib.parse_args(REP_ARGS + extra), grid())
        check(record["counts"] == want_counts, f"phase 30 one process "
              f"{tag}: launches {record['counts']}, want {want_counts}")
        check(all(map(math.isfinite, record["losses"] + [
            x["r_max"] for x in record["rounds"]])),
            f"phase 30 one process {tag}: losses {record['losses']}, "
            f"rounds {record['rounds']}")
        runs[tag] = dict(record=record, state=state, ms=ms,
                         seconds=time.perf_counter() - t1,
                         peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    one, one_sh = runs["rep"], runs["sharded"]
    diff = rep_compare(one["state"], one_sh["state"],
                       (one["record"]["layout"], lay_sh))
    metric_err = max(rel_err(a[k], b[k]) for a, b in zip(
        one["record"]["rounds"], one_sh["record"]["rounds"])
        for k in ("r_max", "s_max", "f_mean", "eta_mean"))
    check(max(diff.values()) <= 1e-5 and metric_err <= 5e-4,
          f"phase 30: the replicated run against the sharded one: "
          f"|diff| {diff}, metrics {metric_err:.3g} relative")
    want = {p: rep_digests(one["state"], specs, mesh, p)
            for p in range(REP_NODES)}
    want_sh = {(p, s_): rep_digests(one_sh["state"], specs, mesh, p,
                                    slay.columns(s_))
               for p in range(REP_NODES) for s_ in range(2)}
    for r in runs.values():
        del r["state"]
    del state
    gc.collect()
    torch.cuda.empty_cache()
    empty_host_cache()
    t_one = time.perf_counter() - t0
    # (b) the checkpoint's directory and its free space
    ckpt = os.path.join(ROOT, "build", "phase30_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    os.makedirs(ckpt)
    need = 4 * reck_state * 1.2
    free = shutil.disk_usage(ckpt).free
    check(free >= need, f"phase 30b: {free / 1e9:.1f} GB free under "
          f"{ckpt}, the checkpoint needs {need / 1e9:.1f}")
    try:
        ranks, call_a = yield ("phase 30", 4, [], REP_LAYERS,
                               dict(arch=REP_ARCH, rep=True, ckpt=ckpt))
        resumed, call_b = yield ("phase 30b", 4, [], REP_LAYERS,
                                 dict(arch=REP_ARCH, rep=True, ckpt=ckpt,
                                      resume=True))
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    rec, rec_sh = one["record"], one_sh["record"]
    for r, b in zip(ranks, resumed):
        pod, c = r["pod"], "".join(map(str, r["coords"]))
        tag = f"phase 30a rank {r['rank']} (pod {pod}, {tuple(r['coords'])})"
        a, sh = r["rep"], r["sharded"]
        check(a["lam_shape"] == [1, total], f"{tag}: lam {a['lam_shape']}, "
              f"want the whole row [1, {total}]")
        same_rounds(tag, {"rank": r["rank"], "rounds": a["rounds"]}, rec)
        check(a["losses"] == rec["losses"], f"{tag}: losses {a['losses']} "
              f"!= {rec['losses']}")
        for name in ("params", "m"):
            check(a[name] == want[pod][c][name], f"{tag}: {name} digests "
                  "differ from the one process's")
        for name in ("lam", "bar", "replicated"):
            check(a[name] == want[pod][name], f"{tag}: {name} differs from "
                  "the one process's")
        check(a["counts"] == want_counts and sh["counts"] == want_counts,
              f"{tag}: launches {a['counts']}, sharded {sh['counts']}")
        check(a["state_bytes"] == reck_state, f"{tag}: state "
              f"{a['state_bytes']} B, reckoned {reck_state}")
        twin = ranks[r["rank"] ^ 1]["rep"]
        check(all(a[k] == twin[k] for k in ("lam", "bar", "replicated")),
              f"{tag}: its in-pod twin's rows differ")
        s_ = r["rank"] % 2
        same_rounds(tag + " sharded", {"rank": r["rank"],
                                       "rounds": sh["rounds"]}, rec_sh)
        for name in ("params", "m"):
            check(sh[name] == want_sh[(pod, s_)][c][name],
                  f"{tag} sharded: {name} digests differ")
        for name in ("lam", "bar", "replicated"):
            check(sh[name] == want_sh[(pod, s_)][name],
                  f"{tag} sharded: {name} differs")
        tag = f"phase 30b rank {r['rank']}"
        fin = b["resumed"]
        check(fin["start_step"] == REP_CKPT_AT, f"{tag}: started at step "
              f"{fin['start_step']}, want {REP_CKPT_AT}")
        check(fin["losses"] == a["losses"][REP_CKPT_AT:],
              f"{tag}: losses {fin['losses']} != the uninterrupted run's "
              f"{a['losses'][REP_CKPT_AT:]}")
        for name in ("params", "m", "lam", "bar", "replicated"):
            check(fin[name] == a[name], f"{tag}: {name} digests differ "
                  "from the uninterrupted run's")
        check(r["first"]["losses"] == a["losses"][:REP_CKPT_AT],
              f"{tag}: the first run's losses differ")
    gb = 1e9
    bound = row_bound_ms(total, len(rec["offsets"]), "native", bs)
    print(f"phase 30: {REP_ARCH} at full width, {REP_LAYERS} of 32 layers, "
          f"{count / 1e6:.1f} M parameters a node, {total} elements a row, "
          f"bf16; J {REP_NODES} x data {REP_MESH[0]} x model {REP_MESH[1]}; "
          f"{t_one + call_a + call_b:.1f} s (one process {t_one:.1f} s, "
          f"30a's ranks {call_a:.1f} s in a torchrun call shared with "
          f"phases 26 and 29, 30b's torchrun call {call_b:.1f} s) "
          f"[{card_line}]", flush=True)
    for tag, o in runs.items():
        print(f"phase 30a one process {tag}: losses {o['record']['losses']}, "
              f"r_max {[x['r_max'] for x in o['record']['rounds']]}; "
              f"{o['seconds']:.1f} s, steps " + " ".join(
                  f"{x:.3f}" for x in o["record"]["step_seconds"])
              + " s, rounds " + " ".join(
                  f"{x['seconds']:.3f}" for x in o["record"]["rounds"])
              + " s; consensus_round " + " ".join(
                  f"{x:.3f}" for x in o["ms"])
              + f" ms; peak {o['peak_gb']:.2f} GB [{card_line}]", flush=True)
    print(f"phase 30a replicated vs sharded (one process): |diff| params "
          f"{diff['params']:.3g}, lam {diff['lam']:.3g}, theta_bar_prev "
          f"{diff['bar']:.3g} (bound 1e-5); residual metrics "
          f"{metric_err:.3g} relative (bound 5e-4)", flush=True)
    for r in ranks:
        a = r["rep"]
        print(f"phase 30a rank {r['rank']} (pod {r['pod']}, "
              f"{tuple(r['coords'])}): state {a['state_bytes'] / gb:.3f} GB "
              f"(reckoned {reck_state / gb:.3f}: shards "
              f"{a['shard_bytes'] / gb:.3f}, whole rows "
              f"{8 * total / gb:.3f}), peak {a['peak_gb']:.2f} GB (reckoned "
              f"{reck['peak'] / gb:.2f}); steps " + " ".join(
                  f"{x:.3f}" for x in a["step_s"]) + " s, rounds "
              + " ".join(f"{x['seconds']:.3f}" for x in a["rounds"])
              + " s; consensus_round on the whole row " + " ".join(
                  f"{x:.3f}" for x in a["kernel_ms"])
              + f" ms (bound {bound:.3f} ms); sharded: peak "
              f"{r['sharded']['peak_gb']:.2f} GB, rounds " + " ".join(
                  f"{x['seconds']:.3f}" for x in r["sharded"]["rounds"])
              + " s, slab kernel " + " ".join(
                  f"{x:.3f}" for x in r["sharded"]["kernel_ms"])
              + f" ms [{card_line}]", flush=True)
    for r, b in zip(ranks, resumed):
        t, tb = r["timed"], b["timed"]
        print(f"phase 30b rank {r['rank']}: wrote {r['written'] / gb:.3f} GB "
              f"(reckoned {reck_state / gb:.3f}); save_async "
              + " ".join(f"{x:.3f}" for x in t["save_async"])
              + f" s (the host copy), wait_pending "
              f"{t['wait_pending'][-1]:.3f} s (the writes, barriers and "
              "rename); restore "
              + " ".join(f"{x:.3f}" for x in tb["restore"])
              + f" s (warm page cache); host peak {r['host_gb'][1]:.2f} GB "
              f"(first run), {b['host_gb'][1]:.2f} GB (resumed run); final "
              f"digests equal the uninterrupted run's [{card_line}]",
              flush=True)
    print("phase 30: NCCL across cards has not run: the ranks share one "
          "card, over gloo", flush=True)
    ms = [x for r in ranks for x in r["rep"]["kernel_ms"][1:]]
    launches = 2 * n_rounds + sum(
        r[k]["counts"]["launches"] for r in ranks
        for k in ("rep", "sharded", "first")) + sum(
        b["resumed"]["counts"]["launches"] for b in resumed)
    return dict(launches=launches, whole_row_ms=float(np.median(ms)),
                whole_row_bound_ms=bound, total=total,
                seconds=time.perf_counter() - t0)


# phase 31: tensor-parallel serving from sharded parameters
# (launch.steps.make_serve_fns on a data 2 x model 2 mesh): qwen3-4b at full
# width, 4 of 36 layers, then rwkv6-7b, 2 of 32, bf16: one process, then 4
# gloo ranks sharing the card, each holding its shards only
TP_MESH = (2, 2)
TP_ARCHS = (("qwen3-4b", 4), ("rwkv6-7b", 2))
TP_BATCH, TP_PROMPT, TP_DECODE = 4, 512, 8
TP_STATS_DECODE = 1             # decode steps of the stats-on run
TP_SEED = 31
# the bf16 sharded rwkv6-7b prefill's distance from the float32 unsharded
# one, at most this many times the bf16 unsharded prefill's: both round
# the same products once in bf16, and the split adds one bf16 rounding of
# each row-parallel partial before its float32 sum
TP_BF16_MARGIN = 2.0


def tp_prompts(cfg):
    """Phase 31's seeded prompts [4, 512] (the same in every process)."""
    import torch
    return torch.randint(0, cfg.vocab, (TP_BATCH, TP_PROMPT), device=DEV,
                         generator=torch.Generator(DEV).manual_seed(
                             TP_SEED + 1))


class LaunchHeads:
    """The head count of every flash and scan kernel launch made inside
    (``kernels.flash_attention.launch``'s q and ``kernels.rwkv6_scan
    .launch``'s r, [B, S, H, hd])."""

    def __enter__(self):
        from repro_torch.kernels import flash_attention as fa
        from repro_torch.kernels import rwkv6_scan as rw
        self.flash, self.scan = [], []
        self.mods = (fa, rw)
        self.saved = (fa.launch, rw.launch)

        def flash(q, *a, **kw):
            self.flash.append(int(q.shape[2]))
            return self.saved[0](q, *a, **kw)

        def scan(r, *a, **kw):
            self.scan.append(int(r.shape[2]))
            return self.saved[1](r, *a, **kw)
        fa.launch, rw.launch = flash, scan
        return self

    def __exit__(self, *exc):
        self.mods[0].launch, self.mods[1].launch = self.saved
        return False


def state_bytes(state) -> int:
    return sum(t.numel() * t.element_size()
               for entry in state.cache.values() for t in entry)


def reckon_tp_peak(cfg, mesh) -> dict:
    """Phase 31's peak device bytes a rank, reckoned from the code before
    the run (PERF.md): resident, its parameter shards
    (``fsdp.shard_bytes``) and its shard of the decode state
    (``decode_shard_shapes``); transient, the larger of one layer's
    leaves gathered over ``data`` (the layer's bytes over ``model``) and
    the head's: the LM head's vocab columns gathered over ``data`` (2 B x
    D x V / model) and the prefill's logits (2 B an element: this rank's
    rows and vocab columns; those gathered over ``model`` and
    concatenated, twice its rows' whole vocab; the same over ``data`` for
    the global batch). ``whole`` is the whole-parameter layout: every
    parameter on every rank (2 B each) with the same state and head,
    nothing gathered."""
    from repro_torch.distributed import fsdp
    from repro_torch.launch.steps import decode_shard_shapes
    from repro_torch.models import build_model
    model = build_model(cfg)
    n = model.param_count()
    params = fsdp.shard_bytes(model, mesh)["params"]
    shapes = decode_shard_shapes(cfg, mesh, TP_BATCH, TP_PROMPT)
    itemsize = {"s": 4, "pos": 4}
    state = sum(math.prod(shape) * itemsize.get(f, 2)
                for fam in shapes.values() for f, shape in fam.items())
    rows = TP_BATCH // mesh.data
    v, d = cfg.vocab, cfg.d_model
    layer = 2 * (n - 2 * v * d - d) // cfg.n_layers // mesh.model
    logits = 2 * TP_PROMPT * (rows * v // mesh.model + 2 * rows * v
                              + 2 * TP_BATCH * v)
    head = 2 * d * v // mesh.model + logits
    return dict(params=params, state=state, peak=params + state
                + max(layer, head),
                whole=2 * n + state + logits)


def tp_serve(cfg, mesh, params, prompts):
    """Phase 31's served run on ``mesh`` (the one-process mesh or a
    rank's): a prefill with ``use_kernel`` and ``TP_STATS_DECODE`` decode
    steps with ``mesh.stats`` on, for the model sums' and the data
    gathers' seconds (each collective between two synchronisations of the
    device, so not timed; this pass also warms up); then, with every
    counter from 0 and the stats off, the timed prefill and ``TP_DECODE``
    decode steps from an empty state fed the prompt's first tokens, host
    clock between synchronisations. The timed prefill's logits must equal
    the instrumented one's bit for bit."""
    import torch
    from repro_torch.configs import ShapeCell
    from repro_torch.launch.steps import make_serve_fns
    from repro_torch.models import build_model
    model = build_model(cfg)
    cell = ShapeCell("tp", TP_PROMPT, TP_BATCH, "prefill")
    stats = mesh.stats
    prefill_fn, decode_fn = make_serve_fns(
        model, dataclasses.replace(mesh, stats=None), cell)
    s_prefill, s_decode = make_serve_fns(model, mesh, cell)
    with torch.inference_mode():
        stats.clear()
        traced = digest(s_prefill(params, {"tokens": prompts},
                                  use_kernel=True))
        prefill_coll = coll_seconds(stats)
        stats.clear()
        state = model.init_decode_state(TP_BATCH, TP_PROMPT, DEV, mesh=mesh)
        for i in range(TP_STATS_DECODE):
            s_decode(params, state, {"token": prompts[:, i]})
        decode_coll = {k: v / TP_STATS_DECODE
                       for k, v in coll_seconds(stats).items()}
        del state
    for obj, attr in all_counters():
        setattr(obj, attr, 0)
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode(), LaunchHeads() as heads:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = prefill_fn(params, {"tokens": prompts}, use_kernel=True)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        counts = {f"{obj.__name__}.{attr}": getattr(obj, attr)
                  for obj, attr in all_counters()}
        prefill_heads = dict(flash=list(heads.flash), scan=list(heads.scan))
        state = model.init_decode_state(TP_BATCH, TP_PROMPT, DEV, mesh=mesh)
        steps = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(TP_DECODE):
            lg, state = decode_fn(params, state, {"token": prompts[:, i]})
            steps.append(lg)
        torch.cuda.synchronize()
        decode_ms = (time.perf_counter() - t0) * 1e3 / TP_DECODE
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(digest(logits) == traced, "phase 31: the prefill with the model "
          "sums and gathers timed differs from the timed prefill")
    check(len(heads.flash) + len(heads.scan)
          == len(prefill_heads["flash"]) + len(prefill_heads["scan"]),
          "phase 31: the decode steps launched a kernel")
    return dict(logits=logits, decode=torch.stack(steps),
                prefill_ms=prefill_ms, decode_ms=decode_ms, counts=counts,
                heads=prefill_heads, prefill_coll=prefill_coll,
                decode_coll=decode_coll, state_bytes=state_bytes(state),
                peak_gb=peak_gb)


def tp_worker(spec, cfg, rank, out_dir) -> int:
    """One rank of phase 31 (``chip_smoke.py --ranks-worker SPEC`` with
    ``"tp"`` in the spec): its mesh (``init_mesh``, gloo on the card, on
    the chain's process group), then for each arch its shards drawn from
    the one process's seed (``Model.init(mesh=, specs=)``) and the served
    run; its digests and numbers into ``rank<r>.json``."""
    import torch
    from repro_torch.distributed import MeshStats, fsdp
    from repro_torch.distributed.exchange import empty_host_cache
    from repro_torch.launch.mesh import init_mesh
    from repro_torch.launch.steps import decode_shard_shapes
    from repro_torch.models import build_model
    mesh = init_mesh(*TP_MESH, DEV, backend="gloo", stats=MeshStats())
    out = dict(rank=rank, coords=list(mesh.coords), device=str(mesh.device),
               archs={})
    for arch, layers in TP_ARCHS:
        c = zoo_config(arch, layers)
        model = build_model(c)
        specs, _ = fsdp.specs_for(model, mesh)
        torch.cuda.reset_peak_memory_stats()
        params = model.init(torch.Generator(DEV).manual_seed(TP_SEED), DEV,
                            mesh=mesh, specs=specs)
        torch.cuda.synchronize()
        init_peak = torch.cuda.max_memory_allocated() / 1e9
        run = tp_serve(c, mesh, params, tp_prompts(c))
        shapes = decode_shard_shapes(c, mesh, TP_BATCH, TP_PROMPT)
        want_state = model.init_decode_state(TP_BATCH, TP_PROMPT, "meta",
                                             mesh=mesh)
        out["archs"][arch] = dict(
            logits=digest(run["logits"]),
            decode=[digest(t) for t in run["decode"]],
            param_bytes=tree_bytes(params),
            reckoned=fsdp.shard_bytes(model, mesh)["params"],
            state_bytes=run["state_bytes"],
            state_reckoned=state_bytes(want_state),
            state_shapes={f"{n}/{f}": list(s) for n, fam in shapes.items()
                          for f, s in fam.items()},
            counts=run["counts"], heads=run["heads"],
            prefill_ms=run["prefill_ms"], decode_ms=run["decode_ms"],
            prefill_coll=run["prefill_coll"],
            decode_coll=run["decode_coll"], peak_gb=run["peak_gb"],
            init_peak_gb=init_peak,
            staging=pinned_bytes(mesh.staging), host_gb=host_gb())
        del params, run
        gc.collect()
        torch.cuda.empty_cache()
        empty_host_cache()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    return 0


def uncounted_prefill(model, params, prompts, mesh=None, use_kernel=True):
    """The prefill on ``mesh`` (None: without one, whole parameters), its
    launches not counted."""
    import torch
    from repro_torch.configs import ShapeCell
    from repro_torch.launch.steps import make_serve_fns
    before = [getattr(o, a) for o, a in all_counters()]
    with torch.inference_mode():
        out = make_serve_fns(model, mesh, ShapeCell(
            "tp", TP_PROMPT, TP_BATCH, "prefill"))[0](
                params, {"tokens": prompts}, use_kernel=use_kernel)
    for (o, a), v in zip(all_counters(), before):
        setattr(o, a, v)
    return out.float()


def tp_against_unsharded(cfg, model, params, prompts, logits) -> dict:
    """Phase 31's checks of the sharded prefill (``logits``, one process,
    the kernel on each shard's heads), with the serve bound of layers x
    2^-8 of max|logit|: against the unsharded prefill with the kernel, and
    against the same sharded prefill without it (the kernel held against
    its plain version at the shards' head counts, 16 of 32 or 32 of 64).

    rwkv6-7b's random weights magnify round-off (phase 11): in bf16 its
    unsharded kernel and plain prefills are further apart than that bound
    at 2 layers, and the sharded prefill, whose column-split products
    round r, k, v, g and both row-parallel outputs apart, further still.
    So both bounds are held in float32 at full width (the same seed drawn
    in float32, the sharded prefills on the one-process mesh), where the
    split's round-off stays far below them and a wrong head, decay or
    state slice would not; and the bf16 sharded prefill is held against
    the float32 unsharded one, within ``TP_BF16_MARGIN`` times the bf16
    unsharded prefill's own distance from it, which a cast or a sum in
    the wrong type on the split path alone would exceed."""
    import torch
    from repro_torch.distributed import local_mesh
    from repro_torch.models import build_model
    one = local_mesh(*TP_MESH, DEV)
    logits = logits.float()
    whole = uncounted_prefill(model, params, prompts)
    scale = float(whole.abs().max())
    out = dict(whole_diff=float((logits - whole).abs().max()),
               bound=cfg.n_layers * 2.0 ** -8 * scale)
    if not cfg.rwkv:
        out["plain_diff"] = float((logits - uncounted_prefill(
            model, params, prompts, one, use_kernel=False)).abs().max())
        check(out["whole_diff"] <= out["bound"], f"phase 31 {cfg.arch_id}: "
              f"the sharded prefill is {out['whole_diff']:.4g} from the "
              f"unsharded one, bound {out['bound']:.4g}")
        check(out["plain_diff"] <= out["bound"], f"phase 31 {cfg.arch_id}: "
              f"the sharded prefill with the kernel is "
              f"{out['plain_diff']:.4g} from the one with plain attention, "
              f"bound {out['bound']:.4g}")
        return out
    out["witness"] = float((uncounted_prefill(model, params, prompts,
                                              use_kernel=False)
                            - whole).abs().max())
    c32 = dataclasses.replace(cfg, dtype="float32")
    m32 = build_model(c32)
    p32 = m32.init(torch.Generator(DEV).manual_seed(TP_SEED), DEV)
    whole32 = uncounted_prefill(m32, p32, prompts)
    tp32 = uncounted_prefill(m32, p32, prompts, one)
    out["f32_diff"] = float((tp32 - whole32).abs().max())
    out["f32_plain_diff"] = float((tp32 - uncounted_prefill(
        m32, p32, prompts, one, use_kernel=False)).abs().max())
    out["f32_bound"] = cfg.n_layers * 2.0 ** -8 * float(whole32.abs().max())
    out["bf16_whole_to_f32"] = float((whole - whole32).abs().max())
    out["bf16_to_f32"] = float((logits - whole32).abs().max())
    out["bf16_limit"] = TP_BF16_MARGIN * out["bf16_whole_to_f32"]
    check(out["f32_diff"] <= out["f32_bound"], f"phase 31 "
          f"{cfg.arch_id}: in float32 the sharded prefill is "
          f"{out['f32_diff']:.4g} from the unsharded one, bound "
          f"{out['f32_bound']:.4g}")
    check(out["f32_plain_diff"] <= out["f32_bound"], f"phase 31 "
          f"{cfg.arch_id}: in float32 the sharded prefill with the scan "
          f"kernel is {out['f32_plain_diff']:.4g} from the one with the "
          f"plain recurrence, bound {out['f32_bound']:.4g}")
    check(out["bf16_to_f32"] <= out["bf16_limit"], f"phase 31 "
          f"{cfg.arch_id}: the bf16 sharded prefill is "
          f"{out['bf16_to_f32']:.4g} from the float32 unsharded one, over "
          f"{TP_BF16_MARGIN} times the bf16 unsharded prefill's "
          f"{out['bf16_whole_to_f32']:.4g}")
    return out


def tp_slice(card_line):
    """Phase 31: tensor-parallel serving from sharded parameters, one
    process against 4 gloo ranks sharing the card. Returns the flash and
    scan kernels' launches on its path."""
    import torch
    from repro_torch.distributed import MeshStats, local_mesh
    from repro_torch.distributed.exchange import empty_host_cache
    from repro_torch.models import build_model
    t0 = time.perf_counter()
    one, gb = {}, 1e9
    n_shards = TP_MESH[0] * TP_MESH[1]
    for arch, layers in TP_ARCHS:
        cfg = zoo_config(arch, layers)
        model = build_model(cfg)
        gc.collect()
        torch.cuda.empty_cache()
        params = model.init(torch.Generator(DEV).manual_seed(TP_SEED), DEV)
        prompts = tp_prompts(cfg)
        run = tp_serve(cfg, local_mesh(*TP_MESH, DEV, stats=MeshStats()),
                       params, prompts)
        kern = "rwkv6_scan" if cfg.rwkv else "flash_attention"
        want = dict.fromkeys(run["counts"], 0)
        want[f"{kern}.launches"] = layers * n_shards
        if not cfg.rwkv:
            want["flash_attention.tc_launches"] = layers * n_shards
        check(run["counts"] == want, f"phase 31 {arch}: one process's "
              f"launches {run['counts']}, want {want}")
        logits, dec = run["logits"], run["decode"]
        check(tuple(logits.shape) == (TP_BATCH, TP_PROMPT, cfg.vocab)
              and tuple(dec.shape) == (TP_DECODE, TP_BATCH, cfg.vocab)
              and bool(torch.isfinite(logits).all())
              and bool(torch.isfinite(dec).all()),
              f"phase 31 {arch}: prefill logits {tuple(logits.shape)}, "
              f"decode {tuple(dec.shape)}, or not finite")
        held = tp_against_unsharded(cfg, model, params, prompts, logits)
        one[arch] = dict(
            logits=digest(logits), decode=[digest(t) for t in dec],
            prefill_ms=run["prefill_ms"], decode_ms=run["decode_ms"],
            peak_gb=run["peak_gb"], heads=run["heads"],
            prefill_coll=run["prefill_coll"], decode_coll=run["decode_coll"],
            state_bytes=run["state_bytes"], count=model.param_count(),
            **held)
        del params, run, logits, dec
    gc.collect()
    torch.cuda.empty_cache()
    empty_host_cache()
    t1 = time.perf_counter()
    ranks, seconds = yield ("phase 31", n_shards, [], TP_ARCHS[0][1],
                            dict(arch=TP_ARCHS[0][0], tp=True))
    rank_mesh = local_mesh(*TP_MESH, DEV)
    launches = {"flash_attention": 0, "rwkv6_scan": 0}
    for arch, layers in TP_ARCHS:
        cfg = zoo_config(arch, layers)
        o = one[arch]
        kern = "rwkv6_scan" if cfg.rwkv else "flash_attention"
        launches[kern] += layers * n_shards
        want = dict.fromkeys(ranks[0]["archs"][arch]["counts"], 0)
        want[f"{kern}.launches"] = layers
        if not cfg.rwkv:
            want["flash_attention.tc_launches"] = layers
        want_heads = dict(flash=[] if cfg.rwkv else
                          [cfg.n_heads // TP_MESH[1]] * layers,
                          scan=[cfg.n_heads // TP_MESH[1]] * layers
                          if cfg.rwkv else [])
        reck = reckon_tp_peak(cfg, rank_mesh)
        for r in ranks:
            a = r["archs"][arch]
            tag = f"phase 31 {arch} rank {r['rank']}"
            check(a["logits"] == o["logits"] and a["decode"] == o["decode"],
                  f"{tag}: logits differ from the one process's")
            check(a["counts"] == want, f"{tag}: launches {a['counts']}, "
                  f"want {want}")
            check(a["heads"] == want_heads, f"{tag}: kernel launches on "
                  f"{a['heads']} heads, want {want_heads}")
            check(a["param_bytes"] == a["reckoned"], f"{tag}: holds "
                  f"{a['param_bytes']} parameter bytes, its shards are "
                  f"{a['reckoned']}")
            check(a["state_bytes"] == a["state_reckoned"],
                  f"{tag}: decode state {a['state_bytes']} bytes, its shard "
                  f"shapes {a['state_shapes']} are "
                  f"{a['state_reckoned']} bytes")
            launches[kern] += a["counts"][f"{kern}.launches"]
        print(f"phase 31 {arch} one process ({layers} layers at full width, "
              f"{o['count'] / gb:.3f} B parameters, {2 * o['count'] / gb:.2f}"
              f" GB in bf16): prefill {o['prefill_ms']:.2f} ms, decode "
              f"{o['decode_ms']:.3f} ms a token, peak {o['peak_gb']:.2f} GB, "
              f"decode state {o['state_bytes'] / gb:.4f} GB; sharded vs "
              f"unsharded prefill {o['whole_diff']:.4g} (bound "
              f"{o['bound']:.4g}" + (
                  f", not held in bf16: the unsharded kernel and plain "
                  f"prefills {o['witness']:.4g} apart; in float32 "
                  f"{o['f32_diff']:.4g}, and the sharded scan kernel vs "
                  f"plain {o['f32_plain_diff']:.4g}, bound "
                  f"{o['f32_bound']:.4g}; bf16 sharded vs float32 unsharded"
                  f" {o['bf16_to_f32']:.4g}, limit {o['bf16_limit']:.4g} "
                  f"({TP_BF16_MARGIN} x the bf16 unsharded prefill's "
                  f"{o['bf16_whole_to_f32']:.4g}))"
                  if "witness" in o else
                  f"; the sharded flash kernel vs plain attention "
                  f"{o['plain_diff']:.4g})")
              + f"; kernel launches on heads {o['heads']} [{card_line}]",
              flush=True)
        for r in ranks:
            a = r["archs"][arch]
            pc, dc = a["prefill_coll"], a["decode_coll"]
            print(f"phase 31 {arch} rank {r['rank']} {tuple(r['coords'])} "
                  f"on {r['device']}: parameters {a['param_bytes'] / gb:.4f}"
                  f" GB (its shards, reckoned {a['reckoned'] / gb:.4f}; "
                  f"whole {2 * o['count'] / gb:.4f}), decode state "
                  f"{a['state_bytes'] / gb:.4f} GB (whole "
                  f"{o['state_bytes'] / gb:.4f}); peak {a['peak_gb']:.2f} "
                  f"GB (reckoned {reck['peak'] / gb:.2f}; the "
                  f"whole-parameter layout {reck['whole'] / gb:.2f}), "
                  f"while drawing {a['init_peak_gb']:.2f} GB; prefill "
                  f"{a['prefill_ms']:.2f} ms, decode {a['decode_ms']:.3f} "
                  f"ms a token; stats-on prefill: model sums "
                  f"{pc['sum_s']:.4f} s in {pc['sum_calls']} calls, data "
                  f"gathers {pc['gather_s']:.4f} s in {pc['gather_calls']};"
                  f" a stats-on decode step: sums {dc['sum_s']:.4f} s, "
                  f"gathers {dc['gather_s']:.4f} s (host clock, staged "
                  f"gloo); kernel launches on heads {a['heads']} "
                  f"[{card_line}]", flush=True)
    print("phase 31: NCCL across cards has not run: the ranks share one "
          "card, over gloo", flush=True)
    print(f"phase 31: one process {t1 - t0:.1f} s, ranks {seconds:.1f} s",
          flush=True)
    return dict(launches=launches,
                one_process={a: {k: one[a][k] for k in (
                    "prefill_ms", "decode_ms", "peak_gb", "whole_diff",
                    "bound", "plain_diff", "witness", "f32_diff",
                    "f32_plain_diff", "f32_bound", "bf16_whole_to_f32",
                    "bf16_to_f32", "bf16_limit")
                    if k in one[a]} for a in one},
                ranks=[{a: {k: r["archs"][a][k] for k in (
                    "prefill_ms", "decode_ms", "peak_gb", "prefill_coll",
                    "decode_coll")} for a in r["archs"]} for r in ranks])


def sass_of(name):
    """Kernel ``name``'s SASS instruction counts (in a worker process)."""
    from repro_torch.kernels import build
    return build.sass_counts(build.sass(name))


def start_build():
    """Phase 2's work on a thread of its own, so that the paper slice, which
    launches no kernel of the port, runs on the card meanwhile: every source
    built (one nvcc each, all started together), then every library's
    ``cuobjdump -sass`` counted, one spawned process a source. Returns the
    future of (the build records, their seconds, {source: SASS counts})."""
    import concurrent.futures as cf
    import multiprocessing as mp

    def work():
        from repro_torch.kernels import build
        t0 = time.perf_counter()
        built = build.build_all(SOURCES)
        seconds = time.perf_counter() - t0
        with cf.ProcessPoolExecutor(
                len(SOURCES), mp_context=mp.get_context("spawn")) as pool:
            counts = dict(zip(SOURCES, pool.map(sass_of, SOURCES)))
        return built, seconds, counts
    ex = cf.ThreadPoolExecutor(1)
    fut = ex.submit(work)
    ex.shutdown(wait=False)
    return fut


def build_phase(building):
    """Phase 2: wait for ``start_build``'s work, then print each kernel's
    registers and spills (nvcc's -Xptxas -v) and its SASS instruction
    counts; each instantiation of the bf16 flash kernel
    (hd 64, 80, 112, 128) must have wgmma, TMA and mbarrier instructions
    and no spills, and each of the cc flash kernel's twelve (f32 and bf16
    at every head dim) mma.sync (HMMA) and cp.async (LDGSTS) instructions
    and no spills; the cc kernel's key tile, dynamic shared bytes and
    blocks per SM are printed beside. Returns (every kernel's counts, the
    tensor-core flash kernel's, its instantiations' registers, the cc
    kernel's {instantiation: counts, registers and launch shape})."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.flash_attention import TC_HEAD_DIMS
    built, seconds, sass_by_source = building.result()
    print(f"build: {', '.join(SOURCES)} in {seconds:.2f} s", flush=True)
    tc_regs, spilled_kernels = {}, set()
    for name, rec in built.items():
        regs, spills, kern, kern_regs = [], [], None, {}
        for ln in rec["log"].splitlines():
            m = re.search(r"Function properties for (\S+)", ln)
            if m:
                kern = build.short_kernel_name(m.group(1))
            m = re.search(r"Used (\d+) registers", ln)
            if m:
                regs.append(int(m.group(1)))
                kern_regs[kern] = int(m.group(1))
            if "spill" in ln and " 0 bytes spill stores" not in ln:
                spills.append(f"{kern}: {ln.strip()}")
                spilled_kernels.add(kern)
        if regs:
            print(f"  {name}: {len(regs)} kernels, {min(regs)}-{max(regs)} "
                  f"registers per thread, {len(spills)} with spills",
                  flush=True)
        for ln in spills:
            print(f"  {name}: {ln}")
        if name == "flash_attention_tc" and rec["log"]:
            # the tensor-core kernel's instantiations, the padded tile's
            # (hd 80, 112) beside hd 64 and 128
            for hd in TC_HEAD_DIMS:
                kn = f"{FLASH_TC_NAME}<{hd}>"
                spilled = any(x.startswith(kn + ":") for x in spills)
                tc_regs[kn] = kern_regs.get(kn)
                print(f"  {kn}: {kern_regs.get(kn)} registers per thread, "
                      f"{'spills' if spilled else 'no spills'}", flush=True)
                check(kn in kern_regs and not spilled,
                      f"{kn}: registers {kern_regs.get(kn)}, spills "
                      f"{spilled} (want it built, without spills)")
    # what the kernels were compiled to: tensor-core products, asynchronous
    # copies and mbarrier operations, counted in each kernel's SASS
    sass = {}
    for name in SOURCES:
        counts = sass_by_source[name]
        sass.update(counts)
        total = {fam: sum(c[fam] for c in counts.values())
                 for fam in build.SASS_FAMILIES}
        print(f"  sass {name}: {len(counts)} kernels, in all " + ", ".join(
            f"{fam} {n}" for fam, n in total.items()), flush=True)
    tc_sass = {kn: c for kn, c in sass.items()
               if kn.startswith(FLASH_TC_NAME + "<")}
    for kern, counts in tc_sass.items():
        print(f"  sass {kern}: " + ", ".join(
            f"{fam} {n}" for fam, n in counts.items()), flush=True)
    want = {f"{FLASH_TC_NAME}<{hd}>" for hd in TC_HEAD_DIMS}
    check(set(tc_sass) == want and all(
        c["HGMMA"] > 0 and c["UTMALDG"] > 0 and c["SYNCS"] > 0
        for c in tc_sass.values()),
        f"the bf16 flash kernel's SASS lacks an instantiation of "
        f"{sorted(want)} or wgmma, TMA or mbarrier instructions in one: "
        f"{tc_sass}")
    # the cc kernel: mma.sync in TF32 parts, K/V by cp.async, each
    # instantiation with its launch shape on this card
    cc = {}
    for dt, tag in ((torch.float32, "float"), (torch.bfloat16, "bf16")):
        for hd in fa.HEAD_DIMS:
            kn = f"{FLASH_NAME}<{tag},{hd}>"
            info = fa.info(dt, hd)
            counts = sass.get(kn, {})
            cc[kn] = dict(sass=counts, **info)
            print(f"  sass {kn}: " + ", ".join(
                f"{fam} {n}" for fam, n in counts.items())
                + f"; {info['registers']} registers per thread, "
                f"{'spills' if kn in spilled_kernels else 'no spills'}, key "
                f"tile {info['key_tile']}, {info['smem_bytes']} dynamic "
                f"shared bytes a block, {info['blocks_per_sm']} blocks per "
                "SM", flush=True)
    check(all(c["sass"].get("HMMA", 0) > 0 and c["sass"].get("LDGSTS", 0) > 0
              and kn not in spilled_kernels for kn, c in cc.items()),
          "the cc flash kernel's SASS lacks an instantiation, or mma.sync or "
          "cp.async instructions in one, or one spills: "
          + str({kn: (c["sass"], c["registers"]) for kn, c in cc.items()}))
    return sass, tc_sass, tc_regs, cc


def kernel_entry(name, source, replaces, launches, numbers, **extra):
    """One kernel's record for the ``kernels`` line."""
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            **{k: numbers[k] for k in ("max_abs_err", "ms", "plain_ms",
                                       "bound_ms", "bound_by")},
            "library_ms": None, **extra}


class Laps:
    """The seconds of each part of ``main``, printed as it ends."""

    def __init__(self):
        self.start = self.last = time.perf_counter()

    def __call__(self, label: str) -> None:
        now = time.perf_counter()
        print(f"timing: {label} {now - self.last:.1f} s (at "
              f"{now - self.start:.1f} s)", flush=True)
        self.last = now


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs one "
              "NVIDIA card", file=sys.stderr)
        return 2
    if len(sys.argv) == 3 and sys.argv[1] == "--ranks-worker":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        rc = ranks_worker(sys.argv[2])
        # the results are on disk: end here, without the interpreter's
        # teardown of the rank's CUDA context and pinned host blocks
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(rc)
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import stacked_defs
    from repro_torch.optim.flatten import FlatLayout

    # -- 1. card ----------------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    lap = Laps()
    card_line = smi[0].strip()
    print(card_line, flush=True)
    print_clocks("start")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    # -- 2. build: one nvcc per source, all started together; meanwhile
    # 13-15, the paper slice's runs, which launch no kernel of the port ----
    building = start_build()
    t0 = time.perf_counter()
    paper_phases(card_line)
    print(f"paper slice: phases 13-15 {time.perf_counter() - t0:.1f} s, "
          "beside the kernel build", flush=True)
    lap("paper 13-15 beside the build")
    sass, tc_sass, tc_regs, cc_kernel = build_phase(building)
    lap("build")

    # -- 9. flash attention vs its plain version and the library ----------
    flash = flash_case("path", card_line, seed=31, model_layout=True)
    check_tc_against_library("path", flash)
    flash_case("gqa", card_line, kv=8, seed=32)
    flash_case("window", card_line, window=256, seed=33)
    flash_f32 = flash_case("f32", card_line, dtype="float32", seed=34)
    # the cc kernel's own bf16 route
    flash_cc_bf16 = {f"hd{hd}": flash_case(f"bf16 hd{hd}", card_line, hd=hd,
                                           seed=35 + n)
                     for n, hd in enumerate((16, 32))}
    check(all(r["route"] == "cc" for r in flash_cc_bf16.values()),
          "flash bf16 at hd 16 and 32: routed to "
          + str({k: r["route"] for k, r in flash_cc_bf16.items()}))
    lap("flash cases")

    # -- 10. the RWKV6 scan vs its plain version ------------------------------
    scan_f32 = scan_case("float32", card_line, seed=41)
    scan = scan_case("bfloat16", card_line, seed=42)
    print(f"  sass {SCAN_PATH}: " + ", ".join(
        f"{fam} {n}" for fam, n in sass[SCAN_PATH].items()), flush=True)
    lap("scan cases")

    # -- 3. kernel vs plain version at three shapes -------------------------
    full = get_config("qwen3-4b")
    one_layer = stacked_defs(dataclasses.replace(full, n_layers=1),
                             torch.bfloat16)["blocks"]
    lay_layer = FlatLayout.for_tree(one_layer, block_size=65536,
                                    node_axis=False)
    lay_attn = FlatLayout.for_tree(one_layer["attn"], block_size=65536,
                                   node_axis=False)
    kernel_case("bf16/native", lay_layer, 2, [1], torch.bfloat16, "native",
                seed=1)
    kernel_case("bf16/int8", lay_layer, 2, [1], torch.bfloat16, "int8",
                seed=2)
    kernel_case("J4/deg2", lay_attn, 4, [1, 3], torch.bfloat16, "native",
                seed=3)
    torch.cuda.empty_cache()
    lap("kernel cases")

    # -- 6. the gated kernel vs its plain version ---------------------------
    for n, (codec, variant) in enumerate((("native", "kick"),
                                          ("native", "gated"),
                                          ("int8", "kick"))):
        exact_case(f"masked bf16/{codec}/{variant}", lay_layer, 4, [1, 2, 3],
                   torch.bfloat16, codec, variant, seed=11 + n)
        torch.cuda.empty_cache()
    lap("masked cases")

    # -- (a) the per-block (fp8) round vs its plain version, one layer ------
    seed = 21
    for codec in ("fp8_e4m3", "fp8_e5m2"):
        for dtype in (torch.bfloat16, torch.float32):
            for variant in ("ungated", "gated", "kick"):
                exact_case(f"per-block {str(dtype)[6:]}/{codec}/{variant}",
                           lay_layer, 4, [1, 2, 3], dtype, codec, variant,
                           seed=seed)
                seed += 1
                torch.cuda.empty_cache()
    lap("per-block cases")

    # -- 4. the slice; (c) the same slice with the fp8_e4m3 wire -----------
    static = static_slice(full, card_line, "native")
    lap("slice native")
    fp8 = static_slice(full, card_line, "fp8_e4m3")
    lap("slice fp8")
    layout = static["layout"]

    # -- 4b. the same trainer on the card and on the CPU -------------------
    agree_with_cpu()
    lap("agree")

    # -- 7. the dynamic-topology slice --------------------------------------
    dyn = dynamic_slice(full, card_line)
    torch.cuda.empty_cache()
    lap("dyn")

    # -- 7b, (d). the dynamic trainer on the card and on the CPU -----------
    agree_dynamic_with_cpu()
    lap("dagree native")
    agree_dynamic_with_cpu(codec="fp8_e5m2", rtol=1e-4)
    lap("dagree e5m2")

    # -- 5. the kernel at the slice's own shape ---------------------------
    full_numbers = full_shape_check(layout, 2, offsets=[1])
    lap("full native")

    # -- (b) the per-block round at the slice's own shape -------------------
    fp8_full = full_shape_check(layout, 2, offsets=[1], seed=6,
                                codec_name="fp8_e4m3")
    lap("full fp8")

    # -- 8. the gated kernel at the dynamic slice's own shape --------------
    dyn_full = full_shape_check(dyn["layout"], 3, offsets=[1, 2],
                                gated=True, seed=8)
    lap("dfull")

    # -- 18, 18c. the async slice; its frozen rows and a captured round -----
    t0 = time.perf_counter()
    asy = async_slice(full, card_line)
    t1 = time.perf_counter()
    afull = async_checked(full)
    lap("async 18 and 18c")
    t2 = time.perf_counter()

    # -- 18b. the async trainer on the card and on the CPU ------------------
    agree_async_with_cpu()
    lap("aagree native")
    # not phase 7b's 1e-4 for fp8_e5m2: card and CPU round their float32
    # matmuls apart, which flips some e5m2 codes of the wire, and the
    # probes of the flipped payloads move the NAP penalties (2.6e-4 of
    # eta_mean on an H100, where the native wire agrees to 5e-6)
    agree_async_with_cpu(codec="fp8_e5m2", rtol=1e-3)
    lap("aagree e5m2")
    async_zero_is_sync()
    lap("async zero")
    print(f"async slice: phase 18 {t1 - t0:.1f} s, its checked run and 18c "
          f"{t2 - t1:.1f} s, 18b {time.perf_counter() - t2:.1f} s",
          flush=True)

    # -- 19, 19b, 19c. observability on the dynamic and async paths --------
    t0 = time.perf_counter()
    obs_dyn = obs_slice("obs dyn", full, OBS_DYN_ARGS, card_line,
                        dyn["in_round_ms"])
    lap("obs dyn")
    obs_async = obs_slice("obs async", full, OBS_ASYNC_ARGS, card_line,
                          asy["in_round_ms"])
    lap("obs async")
    t1 = time.perf_counter()
    agree_obs_with_cpu("dynamic")
    lap("oagree dynamic")
    agree_obs_with_cpu("async")
    lap("oagree async")
    # e5m2 keeps two mantissa bits: card and CPU round their float32
    # matmuls apart, some wire codes flip, the probes of the flipped
    # payloads move the NAP penalties, and over free-running rounds this
    # compounds (PERF.md section 7); each round starts from the card's state
    agree_obs_with_cpu("async", codec="fp8_e5m2", shared=True)
    lap("oagree e5m2")
    print(f"obs slice: phases 19 and 19b {t1 - t0:.1f} s, 19c "
          f"{time.perf_counter() - t1:.1f} s", flush=True)

    # -- 24, 27. three gloo ranks sharing the card, in one torchrun call:
    # the ranks slice against one process; the round pipeline and the async
    # executor across ranks; 25. one NCCL rank against the static slice ---
    t0 = time.perf_counter()
    ranks, pipe = together("phases 24 and 27",
                           [ranks_slice(full, card_line),
                            pipe_slice(card_line)])
    lap("ranks 24 and pipe 27")
    t1 = time.perf_counter()
    nccl1 = nccl1_slice(static, card_line)
    lap("nccl1 25")
    print(f"ranks slice: phases 24 and 27 {t1 - t0:.1f} s, 25 "
          f"{time.perf_counter() - t1:.1f} s", flush=True)

    # -- (e) the flat update: one f32 row at the slice's size, and an N that
    # is not a block multiple
    flat = flat_update_check(layout.total, card_line)
    flat_update_check(layout.total - 12_345, card_line)
    lap("flat")

    # -- 11. serving at full width, one arch after the other -------------
    serve_qwen = serve_slice("qwen3-4b", card_line)
    lap("serve qwen")
    serve_rwkv = serve_slice("rwkv6-7b", card_line)
    lap("serve rwkv")

    # -- 12. reduced serving, card against CPU ------------------------------
    for arch in ("qwen3-4b", "rwkv6-7b"):
        agree_serve_with_cpu(arch)
        lap(f"sagree {arch}")

    # -- 20-23. the model zoo ----------------------------------------------
    t0 = time.perf_counter()
    zflash = zoo_flash(card_line)
    lap("zoo flash")
    t1 = time.perf_counter()
    zserve = {arch: zoo_serve(arch, card_line) for arch in ZOO}
    lap("zoo serve")
    check(all(z["route"] == "tc" for z in zserve.values()),
          "zoo serve: flash routes " + str({a: z["route"]
                                            for a, z in zserve.items()})
          + ", want the tensor-core kernel for every arch")
    t2 = time.perf_counter()
    ztrain = {arch: zoo_train(arch, card_line) for arch in ZOO_TRAIN_LAYERS}
    lap("zoo train")
    print("zoo train kimi-k2-1t-a32b: not on the card (its embedding and "
          "one layer are 19.4 B parameters a node, about 450 GB of training "
          "state); it trains at reduced size on the CPU only", flush=True)
    t3 = time.perf_counter()
    for arch in ZOO + ("rwkv6-7b",):
        zoo_agree(arch)
        lap(f"zoo agree {arch}")
    print(f"zoo: phase 20 {t1 - t0:.1f} s, 21 {t2 - t1:.1f} s, 22 "
          f"{t3 - t2:.1f} s, 23 {time.perf_counter() - t3:.1f} s",
          flush=True)

    # -- 28. expert-parallel serving: one process, then two gloo ranks -----
    t0 = time.perf_counter()
    ep = ep_slice(card_line)
    lap("ep 28")
    print(f"ep slice: phase 28 {time.perf_counter() - t0:.1f} s",
          flush=True)

    # -- 26, 29, 30, 31. four gloo ranks sharing the card, in one torchrun
    # call (30a's part first: its host peak is the checkpoint's): 26 and
    # 26b, the sharded consensus state, sync and async rounds; 29, the
    # in-pod sharded local step; 30, the reference launcher's command, the
    # consensus state replicated in-pod, then (30b) a fresh torchrun call
    # resuming its checkpoint; 31, tensor-parallel serving --------------------
    t0 = time.perf_counter()
    sharded, inpod, rep, tp = together(
        "phases 26, 29, 30 and 31", [sharded_slice(card_line),
                                     inpod_slice(card_line),
                                     replicated_slice(card_line),
                                     tp_slice(card_line)],
        chain=(2, 0, 1, 3))
    lap("sharded 26, inpod 29, replicated 30, tp 31")
    print(f"four-rank slices: phases 26, 29, 30 and 31 "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # -- 16, 17. the paper slice's timed solves, with the card to itself ----
    t0 = time.perf_counter()
    solve_graph_check(card_line)
    lap("paper graph")
    scale_lsq(card_line)
    lap("scale lsq")
    scale_sfm(card_line)
    lap("scale sfm")
    print(f"paper slice: phases 16 and 17 {time.perf_counter() - t0:.1f} s",
          flush=True)

    src = "src/repro_torch/kernels/csrc/"
    ref_file = "src/repro/kernels/consensus_update.py"
    kernels = [
        kernel_entry("consensus_round", src + "consensus_round.cu",
                     f"{ref_file}:141",
                     static["launches"] + nccl1["launches"] + sum(
                         z["launches"] for z in ztrain.values())
                     + sharded["native"]["launches"]
                     + pipe["sync native"]["launches"]
                     + pipe["sync native depth 1"]["launches"]
                     + inpod["launches"] + rep["launches"],
                     full_numbers, in_round_ms=static["in_round_ms"],
                     inpod={k: inpod[k] for k in (
                         "launches", "one_process_ms", "one_process_bound_ms",
                         "rank_ms", "rank_bound_ms")},
                     replicated={k: rep[k] for k in (
                         "launches", "whole_row_ms", "whole_row_bound_ms",
                         "total")},
                     nccl1_launches=nccl1["launches"],
                     sharded=sharded["native"],
                     pipelined_ranks=pipe["sync native"],
                     sequential_ranks=pipe["sync native depth 1"],
                     zoo_launches={a: z["launches"]
                                   for a, z in ztrain.items()},
                     zoo_in_round_ms={a: z["in_round_ms"]
                                      for a, z in ztrain.items()},
                     zoo_bound_ms={a: z["bound_ms"]
                                   for a, z in ztrain.items()}),
        kernel_entry("consensus_round_masked", src + "consensus_round.cu",
                     f"{ref_file}:221",
                     dyn["launches"] + asy["launches"] + obs_dyn + obs_async
                     + ranks["launches"]
                     + sharded["async fp8_e4m3"]["launches"]
                     + pipe["async fp8_e4m3"]["launches"],
                     dyn_full, in_round_ms=dyn["in_round_ms"],
                     sharded_async=sharded["async fp8_e4m3"],
                     async_ranks=pipe["async fp8_e4m3"],
                     ranks_launches=ranks["launches"],
                     ranks_in_round_ms=ranks["kernel_ms"],
                     ranks_bound_ms=ranks["bound_ms"],
                     ranks_exchange_s=ranks["exchange_s"],
                     ranks_overlap_rounds=ranks["overlap_rounds"],
                     async_launches=asy["launches"],
                     obs_launches=obs_dyn + obs_async,
                     async_in_round_ms=asy["in_round_ms"],
                     async_round_ms=afull["ms"],
                     async_round_plain_ms=afull["plain_ms"],
                     async_round_bound_ms=afull["bound_ms"]),
        kernel_entry("consensus_round_per_block", src + "consensus_round.cu",
                     f"{ref_file}:147",
                     fp8["per_block"] + sharded["fp8_e4m3"]["launches"]
                     + sharded["async fp8_e4m3"]["launches"]
                     + pipe["async fp8_e4m3"]["per_block"],
                     fp8_full, in_round_ms=fp8["in_round_ms"],
                     sharded=sharded["fp8_e4m3"],
                     sharded_async_launches=sharded["async fp8_e4m3"][
                         "launches"],
                     async_ranks_launches=pipe["async fp8_e4m3"][
                         "per_block"]),
        kernel_entry("consensus_update", src + "consensus_update.cu",
                     f"{ref_file}:74", flat["launches"], flat),
        kernel_entry("flash_attention", src + "flash_attention_tc.cu",
                     "src/repro/kernels/flash_attention.py:26",
                     serve_qwen["launches"] + sum(
                         z["launches"] for z in zserve.values())
                     + ep["launches"] + tp["launches"]["flash_attention"],
                     flash,
                     library_ms=flash["library_ms"],
                     in_prefill_ms=serve_qwen["in_prefill_ms"],
                     cc_kernel_ms=flash["cc_ms"],
                     f32_source=src + "flash_attention.cu",
                     **{f"f32_{key}": flash_f32[key] for key in (
                         "ms", "max_abs_err", "plain_ms", "library_ms",
                         "bound_ms", "bound_by", "bound_f32_rate_ms")},
                     cc_bf16={k: {f: v[f] for f in (
                         "route", "max_abs_err", "ms", "plain_ms",
                         "library_ms", "bound_ms", "bound_by")}
                         for k, v in flash_cc_bf16.items()},
                     cc_instantiations=cc_kernel,
                     sass=tc_sass, tc_registers=tc_regs,
                     zoo_launches={a: z["launches"]
                                   for a, z in zserve.items()},
                     ep_launches=ep["launches"],
                     ep_one_process=ep["one_process"], ep_ranks=ep["ranks"],
                     tp_launches=tp["launches"]["flash_attention"],
                     tp_one_process=tp["one_process"]["qwen3-4b"],
                     tp_ranks=[r["qwen3-4b"] for r in tp["ranks"]],
                     zoo_tc_launches={a: z["launches"] * (z["route"] == "tc")
                                      for a, z in zserve.items()},
                     zoo_in_prefill_ms={a: z["in_prefill_ms"]
                                        for a, z in zserve.items()},
                     zoo_shapes={k: {f: v[f] for f in (
                         "route", "max_abs_err", "ms", "cc_ms", "plain_ms",
                         "library_ms", "bound_ms", "bound_by",
                         "bound_f32_rate_ms")}
                         for k, v in zflash.items()}),
        kernel_entry("rwkv6_scan", src + "rwkv6_scan.cu",
                     "src/repro/kernels/rwkv6_scan.py:30",
                     serve_rwkv["launches"] + tp["launches"]["rwkv6_scan"],
                     scan, tp_launches=tp["launches"]["rwkv6_scan"],
                     tp_one_process=tp["one_process"]["rwkv6-7b"],
                     tp_ranks=[r["rwkv6-7b"] for r in tp["ranks"]],
                     in_prefill_ms=serve_rwkv["in_prefill_ms"],
                     **{key: scan[key] for key in (
                         "blocks_per_head", "threads", "smem_bytes",
                         "blocks_per_sm", "registers")},
                     f32_ms=scan_f32["ms"],
                     f32_max_abs_err=scan_f32["max_abs_err"],
                     sass={SCAN_PATH: sass[SCAN_PATH]}),
    ]
    print_clocks("end")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
