#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (fl4health_tpu_torch) on one NVIDIA card.

Run from the repository root:  python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught):
  1. Require CUDA; print the card's name and power limit (nvidia-smi).
  2. Build the flash-attention extension from kernels/csrc (sm_90a).
  3. Hold the forward, dQ and dK/dV kernels against their plain PyTorch
     versions at the main path's shapes (B=32, T=2048, H=8, D=64, ragged pad
     masks, one batch element with no real key) in f32 and bf16, and at a T
     that is not a multiple of the 64-row tile. bf16 at D=64 takes the
     tensor-core kernels (wgmma): out, dQ, dK and dV are held to the derived
     bounds of ``bf16_operand_bounds``, lse to TOL below, and a second dQ
     launch must be bit-identical; each check prints the share of its
     bound used. The first slice's CUDA-core bf16 kernels
     are held to TOL on the same inputs, and bf16 at head dim 12 runs them
     through the wrapper and autograd at the ragged T. Then the shape every
     main-path launch has under the client vmap: bf16 [2 x 32, 2048, 8, 64]
     with the mask a [2, 32, 2048] stack of row blocks, each client's own
     (block stride 32 T), shared (stride 0) and inside a wider buffer
     (stride 48 T), launched directly and through the Functions' vmap rules
     (vmap over the clients of vjp), each client's rows held to the plain
     version's bounds. Time each kernel, its plain version,
     F.scaled_dot_product_attention (a yardstick the port never calls) at
     that shape and at one client's, and the CUDA-core kernel of the first
     slice on one client's bf16 inputs, with CUDA events.
  4. A tiny federated run on the card (kernels) against the same run on the
     CPU (plain version): per-round losses and final params within 5e-4.
     Then the same tiny transformer (head dim 64) in bf16 compute for 2
     rounds on the card through the kernels and through the plain version,
     and the plain run in f32 compute: the kernels may move losses and
     params by no more than bf16 compute moves the plain run.
  5. The main path: federated training of the transformer_long configuration
     at full width (vocab 8192, d_model 512, 8 heads, 4 layers, d_ff 2048,
     T 2048, remat, bf16 compute / f32 params) for 2 FedAvg rounds of
     2 clients x 5 local SGD steps of batch 32, with the launch counts set to 0
     just before and read just after. Every round runs both clients in one
     torch.func.vmap, so each launch serves both (88 forward, 40 dQ, 40 dK/dV
     launches, exactly), and every launch must take the tensor cores.
  6. Hold the DP clip kernels (K1 squared norms over a tree, K2 scaled sum,
     and the fused clip over a tree) against their plain versions at the DP
     path's largest leaf [32, 524288], over the whole CifarNet per-example
     tree and at a ragged [7, 1000], in f32 and bf16 (K1 is one launch over
     the tree; K2 splits its rows over threads on the tree's narrow leaves;
     a second launch of either must be bit-identical); time K1 and K2 at the
     largest leaf and over the tree (K1 as one call over the tree, as the
     path makes it), beside their plain versions and one library call each.
     Then the client-batched entries at the DP path's 64 clients x 32
     examples over the CifarNet tree, in both layouts the client vmap may
     leave (K1: one launch of 2,048 rows through client and row strides; K2:
     one launch a leaf with a grid row a client), against the plain versions
     (K2 at atol 1e-5); the fused clip under torch.func.vmap over the clients
     against the plain clip per client, with one K1 launch, one K2 launch a
     leaf and no copy of the per-example tensor; and their times at
     [64, 32, 524288] and over the 64-client tree, beside the plain versions,
     torch.bmm (K2) and vector_norm (K1).
  7. A tiny DP federated run on the card (kernels) against the same run on
     the CPU (plain versions), noise_multiplier 0: within 5e-4.
  8. The DP path: DP-FedAvg of CifarNet at full width (64 clients of 160
     train rows, batch 32, 5 local DP-SGD steps with C = 1 and sigma = 1,
     bf16 compute / f32 params) for 2 rounds under InstanceLevelDpServer, with
     the DP launch counts set to 0 just before and read just after: all 64
     clients in one vmap, so 10 K1 and 80 K2 launches, exactly, and no copy
     of the per-example tensor; its epsilon must equal the accountant's
     value for this configuration.
  9. The random stream on the card: for keys 0, 7 and 2^31 - 1, ``split``,
     ``fold_in``, ``bits``, ``uniform`` (shapes (), (7,), (64,), (3, 5, 11)
     and CifarNet's 579,402 parameters), ``permutation`` (64, 1000),
     ``randint`` and ``categorical`` drawn
     on the card equal the CPU draws bit for bit; ``normal`` within rtol/atol
     1e-6, with the share of bit-exact draws printed; and the time of the
     server noise of one CifarNet round.
 10. A tiny client-level DP run (the ``client_dp_weighted_mnist`` logic and
     strategy: an MLP, noise 0.1, weighted, adaptive clipping; over 8
     uneven clients, Poisson sampling at q = 0.5, 2 rounds, f32) on the card
     against the same run on the CPU: the same sampled masks, and losses,
     params and clipping bound within 5e-4. Then the client axis: a tiny
     run of each path (f32, 2 rounds; the DP one at sigma = 1) through the
     vmap and through its plain version, the Python loop over the clients,
     from the same params: losses and params within 1e-5, and each kernel
     launched once for all clients under the vmap, once a client in the
     loop. Then one full-width round of transformer_long (5 local steps),
     vmapped and looped, in bf16 and in f32: in bf16 the vmap may move the
     round's update by no more than bf16 compute moves the loop's, in f32 by
     at most VMAP_F32_GAP (relative l2).
 11. The client-level DP path, ``client_dp_cifar_cnn``: DP-FedAvgM of CifarNet
     at full width over 64 uneven clients (the client_level_dp_weighted
     example's size profile and strategy settings), Poisson sampling at
     q = 0.25, batch 32, 5 local SGD(0.1) steps, bf16 compute / f32 params,
     2 rounds under ClientLevelDpFedAvgServer, all 64 clients in one vmap.
     It reaches no kernel, as in JAX: every launch counter must stand still
     over the phase; its epsilon must equal the accountant's value for this
     configuration.
 12. The pipelined round made whole, ``pipelined_dp_cifar_cnn``: the DP
     path's configuration (64 clients of 160 train and 64 val rows, batch 32,
     5 local DP-SGD steps, C = 1, sigma = 1, bf16 compute) with a 64-row test
     split a client (from ``PRNGKey(10_000 + i)``), early stopping in chunks
     of 2 steps at patience 1 (3 chunks a round, the last padded: 18 K1 and
     144 K2 launches over 3 rounds, stopped or not, exactly),
     ``FailurePolicy(accept_failures=False)``, a ``JsonReporter`` and
     ``pipeline_depth`` 2, for 3 rounds: finite losses with the ``"test - "``
     keys in every record, the report's rounds equal to the history, and the
     same 3 rounds through the pipeline's plain version (each round's
     epilogue inline) from the same state equal to the pipelined history
     bit for bit (cuDNN deterministic for both). Then a tiny run with a
     NaN-poisoned client: under ``accept_failures=False`` it must raise
     ``ClientFailuresError`` naming that client and round 1; under True it
     must finish, within VMAP_TOL of the run without that client.
 13. Tiny card-vs-CPU runs of the config-2 algorithms (f32, 3 clients, 2
     rounds, the same params): SCAFFOLD with its warm start, FedProx, MOON
     (buffer 2: the contrastive term 0 in round 1, positive in round 2) and
     DP-SCAFFOLD at sigma 1 with its warm start (the kernels on the card):
     losses and params within 5e-4.
 14. ``scaffold_cifar_cnn``, BASELINE.json config 2: CifarNet at full width,
     bf16 compute, over 16 non-IID Dirichlet clients (beta 0.5) of a
     3,584-row pool, batch 32, one local epoch (uneven clients: padded
     steps), SGD(0.01) (the examples' 0.1 diverges on this pool, in the JAX
     package as in the port: ``tests/test_torch_scaffold.py``),
     ``scaffold_warm_start`` then 3 pipelined rounds, under
     ``FailurePolicy(accept_failures=False)`` (a client whose loss turns
     non-finite ends the run): the global params after the warm start equal
     the init bit for bit, the control variates' norm after the warm start
     and each round, finite losses, moving params, no kernel launched (as
     in JAX).
 15. ``fedprox_cifar_cnn``: the same model and clients under
     ``FedAvgWithAdaptiveConstraint`` (mu 0.1, delta 0.1, patience 5) and
     ``FedProxServer``, SGD(0.01), 3 rounds under the same strict policy:
     mu's trajectory, the vanilla and penalty losses.
 16. ``dp_scaffold_cifar_cnn``: the DP path's model and data under
     DP-SCAFFOLD (lr 0.05, C = 1, sigma = 1), ``DpScaffoldServer`` with the
     warm start, 2 rounds under the strict policy: (2 + 1) x 5 steps, so 15
     K1 and 120 K2 launches, exactly, and no copy of the per-example tensor;
     the accountant's epsilon, with the warm start charged as one
     full-participation round, must equal its CPU value. It is printed as
     the accountant's, not as the run's guarantee: the warm start rolls the
     clients' keys back, so round 1 redraws the warm start's noise.
 17. K3-K5 at config 3's shape, bf16 [4 x 32, 128, 12, 64] with a [4, 32,
     128] mask stack (own, shared and strided), directly and through the
     vmap rules, held to the plain version's bounds; and their times there,
     beside their plain versions and SDPA's forward and backward.
 18. Tiny card-vs-CPU runs of config 3's recipe at the bert_lora_fedopt smoke
     config's widths (LoRA rank 4, masked adam, FedOpt(adam), LoRA-only
     exchange, remat, f32): through flash attention (K3-K5 on the card, the
     plain version on the CPU), and with dropout 0.1 in the dense core,
     whose masks on the card equal the CPU's bit for bit (one train call,
     the remat's recompute included); losses and params within 5e-4.
 19. ``bert_lora_fedopt_base``, BASELINE.json config 3 at BERT-base width
     (98,403,844 params in 342 leaves, 666,628 of them trainable), 4 clients
     of 160 train and 32 val rows, batch 32, 5 local steps, bf16 compute,
     flash attention, no remat, 2 pipelined rounds under a strict failure
     policy: 144 forward, 120 dQ and 120 dK/dV launches, exactly, all on
     the tensor cores; finite losses falling over the rounds; each client
     pushes exactly its trainable elements; no frozen leaf of any client
     moves. It starts from a file: its initial params written as a
     BERT-base ``.pt`` state dict in torch's Linear convention, the model
     re-initialized from another seed and warm-started by
     ``warm_up_from_file(torch_linear_convention=True)``, bit-equal to the
     written tree.
 20. ``precision_mnist``: MnistNet (dtype=None) on bench.py's cifar_cnn
     traffic (64 clients, batch 32, 5 SGD(0.05) steps, FedAvg, 28x28x1), 3
     rounds in each of the f32, bf16 and fp16 (dynamic loss scaling) arms
     from the same params: finite falling training losses, a final
     validation loss within 0.05 of f32's, f32 master params and optimizer
     state, the fp16 arm's skipped steps and scale, and no kernel launched.
 21. ``aggregate_64``: the weighted mean at the DP path's 64 clients over
     the CifarNet tree, in XLA's windows of 32 rows: equal on the card and
     the CPU bit for bit, within f32 rounding of the one reduction it
     replaced, both timed. (The DP path's warm walls, phase 8, are read
     with each of the two swapped in, in turns.)
 22. ``tiny_nnunet_parity``: tests/smoke/harness.py's nnunet_synthetic
     (12^3 spheres, features / 4, plans through the handshake) for 2
     rounds on the card and on the CPU from the same params, with and
     without augmentation, TF32 off: losses and params within 5e-4.
 23. ``chunked_vs_pipelined``, cuDNN deterministic in this phase only: the
     DP path (64 clients) and the tiny nnU-Net with augmentation, 2 rounds
     each with ``execution_mode`` "auto" (which must take the chunked route)
     and "pipelined": histories and states equal bit for bit; then both
     routes' warm walls in turns.
 24. ``nnunet_fullres``, BASELINE.json config 5 at nnU-Net's published
     width: the default plans of synthetic spheres at volume size 128 (a
     128^3 patch, batch 2, 6 stages, features 32-320), 2 clients of 10
     patches (8 train), 4 local steps of nnunet_optimizer(5e-3), FedAvg,
     augmentation on, through ``NnunetServer`` and ``execution_mode`` "auto"
     (which must report ``chunked_scan``), cuDNN's TF32 on (PyTorch's
     default; printed): 1 cold and 2 warm rounds with the launch counts set
     to 0 before and read after (none of K1-K5), finite falling losses,
     voxels a second, peak memory, one round under the profiler (busy
     share), then rounds through the client vmap and the loop in turns.
     Then ``nnunet_inference`` on that network and its global params:
     sliding-window inference (a volume equal to the patch, uniform
     weights, equal to the direct forward; a 256x256x192x1 volume at step
     0.5 with the Gaussian map, 18 windows, equal to a float64 blend of the
     card's own windows within 1e-5; a tiny 3-D U-Net on the card within
     5e-4 of the CPU, TF32 off for the checks), ms a volume with TF32 off
     and on, voxels/s, peak memory.
 25. ``tiny_cohort_parity``: a cohort run (6 clients of a ListDataSource
     registry, 3 slots, FixedFractionManager(6, 0.5), the chunked cohort
     route, f32 DP at noise 0, K1/K2 on the card) for 3 rounds on the card
     and on the CPU from the same params: losses and params within 5e-4.
 26. ``cohort_dp_cifar_cnn``: the DP path's model and client (CifarNet,
     bf16, batch 32, 5 DP-SGD steps, C 1, sigma 1, SGD(0.05), FedAvg) over
     ``dirichlet_registry_source`` of a 50,000-row synthetic CIFAR pool
     (drawn on the card) at N 1,000 and N 100,000 clients, beta 0.5,
     ``CohortConfig(slots=64)``, ``FixedFractionManager(N, 64 / N)``,
     ``execution_mode`` "auto" (the chunked cohort route: draws on the
     card): a cold round, then 3 warm rounds with the counts and the peak
     reset: exactly 15 K1 and 120 K2 launches (5 and 40 a round), none of
     K3-K5; the warm round walls, peak device memory, staging, gather and
     scatter ms, staged and pulled bytes, dirty rows and host memory at
     each size, and the 100k-to-1k ratios of the peak and the wall.
 27. ``cohort_chunked_vs_pipelined``, cuDNN deterministic in this phase
     only: N 1,000 with the compressed exchange (top-k 0.1, 8 bits, error
     feedback, seed 3) through both cohort routes, 3 rounds: histories,
     states and the registry's client and error-feedback rows equal bit for
     bit; both routes' warm walls in turns, 2 rounds each.
 28. ``compressed_dp_cifar_cnn``: the dense DP path without and with that
     compression, warm walls in turns; ``logical_nbytes`` and
     ``estimate_wire_nbytes`` of the update; ``compress_update`` over the
     CifarNet tree on the card equal to the CPU's bit for bit.
 29. ``tiny_async_parity``: buffered-async runs (FedBuff) of
     tests/server/test_async_fit.py's Mlp recipe, 4 events, on the card
     through each route and on the CPU from the same params: stragglers,
     dropout, a scaling attacker under RobustFedAvg's median and trimmed
     mean, a 6-client registry in 3 seats. Card within 5e-4 of the CPU; the
     card's two routes bit-equal.
 30. ``async_dp_cifar_cnn``: the DP path under bench.py's
     ``timed_async_block`` recipe (buffer 32 of 64, jitter 0.05, clients 0
     and 1 at 5x compute time), 6 events, cuDNN deterministic in this phase
     only: the chunked ("auto") and the pipelined route, each exactly 35 K1
     and 280 K2 launches (7 waves of 5 steps), none of K3-K5, bit-equal to
     each other; buffer 64 without faults bit-equal to the synchronous run
     on both routes; warm walls of 6 events a route and of 6 synchronous
     rounds in turns; peaks; the virtual cadences.
 31. ``async_cohort_dp_cifar_cnn``: the N 1,000 registry of phase 26 in 64
     seats, the same recipe, 4 events on the registry route: exactly 25 K1
     and 200 K2; the seats change occupants; every evicted occupant's stored
     row equals its state when it left its seat; each event's swap, staging
     and scatter ms.
 32. The checkpoint slice, cuDNN deterministic in these phases only:
     ``ckpt_dp_cifar_cnn`` (the DP path with a frame every round, saved
     after round 2 of 4 and resumed by a fresh simulation on both routes
     and across them: bit-equal to a straight run, 5 K1 and 40 K2 a round
     run; frame bytes, ``write_s``, a restore, the trees' pull; warm rounds
     with a frame every round against none, in turns), ``ckpt_drill`` (the
     SIGKILL drill in child processes, each started before the checkpoint
     phases and warm when its spec comes (``DrillChildPool``): straight,
     killed after round 2's
     frame, killed 4 KiB into round 3's write; the torn run's newest
     generation flipped; the resumed and the falling-back children's final
     params' bytes and loss history equal the straight child's),
     ``ckpt_cohort_dp_cifar_cnn`` (N 1,000, compression with error
     feedback, the chunked cohort route: bit-equal with every dirty row),
     ``ckpt_async_dp_cifar_cnn`` (resumed after event 3 of 6 on both async
     routes, the frames and the history bit-equal; a changed seed refused
     with JAX's message) and ``ckpt_card_to_cpu`` (a card frame resumed on
     the CPU within 5e-4 of the CPU's straight run).
 33. The observability slice, in the same deterministic block:
     ``obs_dp_cifar_cnn`` (the DP path for 2 rounds on each route with
     observability on: an output dir, the watchdog, the scrape endpoint;
     the history and states bit-equal to the off run's, the routes'
     telemetry bit-equal, 10 K1 and 80 K2 either way, ``fl_rounds_total
     2`` and ``/healthz`` 200 scraped live at round 2; the JSONL event
     names, the warm round's wall on and off in turns, the ring's and the
     ledger's bytes), ``obs_halt_bundle`` (client 63's features NaN: the
     watchdog halts naming round 1 and client 63 on both routes, one bundle
     that ``load_bundle`` reads back with verdict ``training_health``,
     ``/healthz`` 503 live), ``obs_cohort_dp_cifar_cnn`` (N 1,000 and
     100,000, 64 slots, 2 chunked rounds: the ledger keyed by registry ids,
     the ring's bytes equal at both N) and ``obs_sigterm_drill`` (the
     checkpoint drill with a SIGTERM after round 2's frame: exit 143, a
     ``sigterm`` bundle, a resume bit-equal to an unkilled child with the
     frame's fleet ledger adopted). Phases 7, 8 and 16 run the telemetry
     build (no fence, no recorder), for DP's clip fraction.
 34. The recovery slice, in the same deterministic block:
     ``tiny_recovery_parity`` (the CPU tests' tiny supervised drill on the
     card and on the CPU: the same verdicts, suspects, rungs, rollbacks,
     roster and ledger, losses and params within 5e-4),
     ``recovery_dp_cifar_cnn`` (the DP path at full width under
     ``InstanceLevelDpServer``, a frame every round, 5 rounds on each route,
     four arms: fault-free; an armed, idle ``RecoveryPolicy`` bit-equal to
     it; a probability-1 scale fault (-15) on 16 named clients from round
     2 unsupervised, halted by the watchdog with one bundle; the same
     supervised, all 5 rounds, the 16 clients on its roster; K1/K2 5 and 40
     a dispatched round as the simulation counts them; the rungs, the
     rollbacks, the epsilon and the wall split into restore, bundle,
     engagement and replayed rounds), ``recovery_cohort`` (the pipelined
     cohort route at N 1,000 with 64 slots: a NaN registry client's failure
     quarantined by registry id, the route's reason, the launches) and
     ``hoisting_server_lr`` (``fed_adam``'s server lr set by
     ``apply_state_scalars``: bit-equal to a run built with it).
 35. The introspection and operations slice, ``ops_dp_cifar_cnn`` (cuDNN
     deterministic): the DP path for 2 pipelined rounds through
     ``InstanceLevelDpServer`` with round-program introspection, an SLO
     policy the run breaches, an admin token and the scrape endpoint, against
     the same run with observability off: bit-equal, 10 K1 / 80 K2 launches
     both, the introspection moving no device byte and no launch count,
     ``/healthz`` ``degraded: eval_loss``; ``fit_round_t``'s counted dot and
     convolution flops equal to the reference FlopCounterMode's over one real
     round, 45 custom calls in its ``dp_clip`` row, conservation; a round's
     ``mfu_pct`` and ``tflops_measured``, the introspected footprint beside
     ``max_memory_allocated``, the HBM headroom. Then the live retune drill
     (``fed_adam``, 4 rounds, ``POST /admin/scalars`` at round 2, journaled,
     no extension build after round 1, replayed bit for bit through
     ``schedule()``) and one introspected round of ``transformer_long`` at
     depth 1: K3-K5 reported as custom calls, none launched.
 36. The sweep slice, ``sweep_dp_cifar_cnn`` (cuDNN deterministic): a
     24-cell grid of the DP path in f32 through ``run_sweep`` with a
     completion ledger ({FedAvg, FedAdam at server lr 0.01 and 0.03} x
     {DP-SGD, DP over MR-MTL} x {even, uneven partitions} x cohorts {48,
     64} in one bucket of 64, packs of 8, 2 rounds a cell): 4 groups, no
     run-time compile, finite cells, K1/K2 240/1920; four unpadded cells (one
     a group) bit-equal to their standalone chunked ``fit`` (10/80 each) and
     the padded 48-client one within 5e-4 of its own (R11); one group with
     ``pack=False`` bit-equal to its packed run (40/320); the ledger's rerun
     restoring all 24 cells with no launch; the CPU tests' tiny grid on the
     card within 5e-4 of the CPU. Then ``ditto_cifar_cnn`` and
     ``mrmtl_cifar_cnn`` over the 64 clients, 2 rounds each: finite losses,
     Ditto's global copies equal and personal copies apart, MR-MTL's params
     off the aggregate, no kernel launched; the warm round and the peak.
 38. The mesh slice (``parallel/``), a one-rank NCCL world from a FileStore:
     ``mesh_dp_cifar_cnn`` (the DP path with ``MeshConfig()`` on the
     pipelined and the chunked route, K1/K2 10/80 a run),
     ``mesh_zero1_bert_lora_fedopt`` (config 3 with ``MeshConfig(zero1=True)``,
     K3/K4/K5 144/120/120) and ``ring_transformer_long`` (the main path with
     ``ring_flash_attention`` over a one-rank seq axis, 88/40/40), each 2
     rounds bit for bit against its unsharded run in the same call; each
     arm's warm round, peak and launches.
 39. The model-state slice: buffered async and an armed admin plane under
     the one-rank NCCL mesh against ``mesh=None``, ``fedpm_mnist`` and
     ``fedbn_bn_mlp``.
 40. The algorithm-breadth slice: every arm's tiny fixture on the card
     against the CPU (1e-5; the deep-kernel arms within twice the CPU
     run's own move on a one-ulp input change), then Ditto and MR-MTL with
     MK-MMD and with deep MMD, Flash, FedDG-GA, dynamic-layer and sparse
     exchange and model merge at 64 clients, 2 rounds, the chunked route
     bit for bit the pipelined one (FedDG-GA: refused, its inline rounds
     instead), the MK-MMD QP's host time; ``fedpca_mnist`` against the
     CPU's SVDs after signs; no K1-K5 launch.
 41. The cross-silo slice: the native framing must be live (the C++
     codec built with ``g++`` at first use, not its Python twin); each arm's
     tiny run on the card against the CPU (5e-4); then
     ``cross_silo_fedprox`` (research/fedprox_cluster/run_local_cluster.py:
     5 ``LoopbackServer`` silos over TCP, 8 rounds, ``fedprox_synthetic``
     120 rows of dim 30 in 6 classes, ``Mlp((16,), 6)``, 4 SGD(0.05) steps
     of batch 8, mu in {0.01, 0.1, 1.0}, 3 runs, ``find_best_hp_dir`` over
     the dumps), ``cross_silo_dp_cifar_cnn`` (4 DP silos of the DP path's
     client, 160 rows, 2 rounds of ``broadcast_round`` and
     ``weighted_merge``: frame bytes, f32 then f64 (ROADMAP.md R13),
     encode and decode ms, K1/K2 5 and 40 a silo-round),
     ``cross_silo_async_compressed`` (examples/cross_silo_buffered_async_
     example: compressed frames, ``SiloUpdateBuffer``, a ``chaos_handler``
     straggler, traced frames: the staleness and the flow ids at both ends)
     and ``tabular_alignment`` (examples/feature_alignment_example: the two
     polls, FedAvg on the card, ``balanced_accuracy``, ``f1``, ``binned_auc``
     on the eval path); no K3-K5 launch.
``fit`` takes its default route, ``execution_mode`` "auto": chunked unless
something needs the host between rounds (a strict failure policy, a data
provider), then pipelined. Neither waits for the device inside a round, so
``fit_elapsed_s``/``eval_elapsed_s`` are dispatch times (the chunked
route's ``fit_elapsed_s`` its chunk's wall a round, ``eval_elapsed_s``
0). Each main path prints the synchronised wall of its rounds and its peak
device memory, then its warm rounds' walls through the pipelined ``fit``
and through the plain version (pipelined, inline, inline, pipelined, 2
rounds each); its throughput is over the pipelined warm walls.
Both extensions are built at the start, in parallel. Then one JSON line with
every kernel, the card line again, and the result line.
"""

from __future__ import annotations

import contextlib
import functools
import importlib
import json
import math
import os
import signal
import statistics
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

B, T, H, D = 32, 2048, 8, 64
RAGGED_T = 2000  # not a multiple of the kernels' 64-row tile
N_CLIENTS, BATCH, LOCAL_STEPS, ROUNDS = 2, 32, 5, 2

# (atol, rtol) per output. f32 are the JAX kernel tests' bounds
# (tests/kernels/test_flash_attention.py). bf16 hold the kernel (bf16 in and
# out) against the plain version in f32 on the same bf16-rounded inputs: they
# differ by the one bf16 rounding of out, dq, dk and dv (at most 2^-8
# relative; rtol is twice that) plus f32 summation noise (about 1e-6 here;
# atol is 100 times that). The tensor-core kernels also round P and dS to
# bf16 as operands: out, dq, dk and dv add the term of
# ``bf16_operand_bounds`` for that rounding to these. lse stays f32 in the
# kernels, so it keeps the f32 bound.
TOL = {
    torch.float32: {"out": (2e-5, 1e-4), "lse": (2e-5, 1e-4), "grad": (5e-4, 1e-4)},
    torch.bfloat16: {"out": (1e-4, 2**-7), "lse": (2e-5, 1e-4), "grad": (1e-4, 2**-7)},
}
# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores; f32 on the
# CUDA cores (f32 here must not use TF32); HBM3 bandwidth
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
SOURCE = "fl4health_tpu_torch/kernels/csrc/flash_attention.cu"
WGMMA_SOURCE = "fl4health_tpu_torch/kernels/csrc/flash_attention_wgmma.cu"
DP_SOURCE = "fl4health_tpu_torch/kernels/csrc/dp_clip.cu"

# The DP path: bench.py's cifar_cnn run (64 clients of 160 train + 64 val
# rows, batch 32, 5 local steps, SGD 0.05, FedAvg, seed 0) with the
# instance-level DP example's C = 1, sigma = 1
DP_CLIENTS, DP_TRAIN, DP_VAL, DP_ROUNDS = 64, 160, 64, 2
DP_CLIP, DP_SIGMA = 1.0, 1.0
# epsilon of that run at delta = 1 / (64 * 160), from the CPU accountant
# (tests/test_torch_dp_clip.py holds both packages' accountants to it)
DP_EPSILON = 4.8447493207072
# (atol, rtol) of the JAX kernel tests (tests/kernels/test_dp_clip.py), for
# f32 and bf16 gradients alike: the kernels and the plain versions widen the
# same values to f32 and sum the same f32 products, in another order
DP_TOL = {"dp_sq_norms": (0.0, 1e-5), "dp_scaled_sum": (1e-5, 0.0),
          "fused": (1e-5, 0.0)}
# The client-level DP path: examples/dp_fed_examples/client_level_dp_weighted
# (its config.yaml's strategy settings; uneven "hospitals" from its
# linspace(64, 256) size profile normalised to the pool) on the CifarNet of
# dp_cifar_cnn, 64 clients from a 14,336-row pool, Poisson sampling at q = 0.25
CDP_CLIENTS, CDP_POOL, CDP_ROUNDS, CDP_FRACTION, CDP_LR = 64, 14336, 2, 0.25, 0.1
CDP_STRATEGY = dict(noise_multiplier=0.1, bit_noise_multiplier=1.0,
                    initial_clipping_bound=2.0, clipping_quantile=0.5,
                    weighted_aggregation=True, adaptive_clipping=True)
# epsilon of that run at delta = 1 / 64, from the CPU accountant
# (tests/test_torch_client_dp.py holds both packages' accountants to it)
CDP_EPSILON = 125.27058177633157
# the strategy of tests/smoke/harness.py's client_dp_weighted_mnist, for the
# tiny card-vs-CPU run
TINY_CDP_STRATEGY = dict(noise_multiplier=0.1, server_momentum=0.5,
                         initial_clipping_bound=0.5, weighted_aggregation=True,
                         adaptive_clipping=True, bit_noise_multiplier=1.0, seed=7)
# The pipelined phase: the DP path with a test split, early stopping in
# chunks of 2 steps at patience 1, a strict failure policy and a JSON report
PIPE_ROUNDS, PIPE_TEST, PIPE_INTERVAL, PIPE_PATIENCE = 3, 64, 2, 1
# BASELINE.json config 2 (CIFAR-10 FedProx + SCAFFOLD, 16 non-IID clients):
# CifarNet over 16 clients cut by DirichletLabelBasedAllocation(beta 0.5, at
# least 1 example of each label a client, hash key 42) from a 3,584-row pool
# (16 x 224, cifar_cnn's rows a client), each split 80/20 with hash key
# 7 + i; batch 32, one local epoch, SCAFFOLD's server lr 1.0 with the warm
# start, FedProx's mu 0.1, delta 0.1 and patience 5 (examples/scaffold_example
# and examples/fedprox_example). Their SGD(0.1) diverges on this pool, in the
# JAX package as in the port (tests/test_torch_scaffold.py: round 1 after
# the warm start loses the same clients to losses past 1e4 in both), so
# both phases' clients take SGD(0.01), under a strict failure policy
ALG_CLIENTS, ALG_POOL, ALG_ROUNDS, ALG_LR, ALG_BETA = 16, 3584, 3, 0.01, 0.5
PROX_STRATEGY = dict(initial_drift_penalty_weight=0.1, loss_weight_delta=0.1,
                     loss_weight_patience=5)
# DP-SCAFFOLD on the DP path's model and data: DpScaffoldClientLogic(lr
# 0.05), Scaffold(1.0), DpScaffoldServer with the warm start, 2 rounds
DPS_ROUNDS, DPS_LR = 2, 0.05
# epsilon of that run at delta = 1 / (64 * 160): 2 rounds and the warm start
# as one full-participation round, from the CPU accountant
# (tests/test_torch_dp_scaffold.py holds both packages' accountants to it)
DPS_EPSILON = 5.731070434636602
# warm rounds a main path runs through each of the pipelined and inline fits
WARM_ROUNDS = 2
# BASELINE.json config 3 (BERT fine-tuning, FedOpt, AG-News-shaped text):
# bench.py's transformer config (vocab 16384, d_model 768, 12 heads, 12
# layers, d_ff 3072, T 128, bf16 compute on f32 params, flash attention, no
# remat) with examples/bert_finetuning_example's LoRA (rank 4), client
# masked adam(0.01), server FedOpt(adam(0.01)) and LoRA-only exchange; 4
# clients of 160 train and 32 val rows, batch 32, 5 local steps, dropout 0
BERT_CFG = dict(vocab_size=16384, n_classes=4, d_model=768, n_heads=12, n_layers=12,
                d_ff=3072, max_len=128)
BERT_CLIENTS, BERT_TRAIN, BERT_VAL, BERT_ROUNDS, BERT_LORA, BERT_LR = 4, 160, 32, 2, 4, 0.01
BERT_PARAMS, BERT_LEAVES, BERT_TRAINABLE = 98_403_844, 342, 666_628
# tests/smoke/harness.py's bert_lora_fedopt, for the tiny card-vs-CPU runs
TINY_BERT = dict(vocab_size=96, n_classes=4, d_model=32, n_heads=2, n_layers=2, d_ff=64,
                 max_len=12)
# precision_mnist: bench.py's cifar_cnn traffic (64 clients of 160 train and
# 64 val rows, batch 32, 5 local SGD(0.05) steps, FedAvg, seed 0) on config
# 1's MnistNet (dtype=None, which the policy reaches) at 28x28x1, 3 rounds
# in each of the f32, bf16 and fp16 arms
PREC_CLIENTS, PREC_ROUNDS = 64, 3
# the pinned bf16-vs-f32 loss gap (tests/precision/test_precision_sim.py's
# CIFAR_BF16_LOSS_ATOL), held here for both low-precision arms
PREC_LOSS_ATOL = 0.05
# BASELINE.json config 5 (nnU-Net 3D segmentation, FedAvg): the plans
# generate_plans makes by default from tests/smoke/harness.py's synthetic
# spheres at volume size 128 (a 128^3 patch, 6 stages, features 32 to 320,
# 3^3 kernels, 2 convs a stage, deep supervision, batch 2 by the 5% rule),
# with examples/nnunet_example/config.yaml's traffic: 2 clients of 4
# volumes, 10 patches each (8 train, 2 val), 4 local steps,
# nnunet_optimizer(5e-3), FedAvg, augmentation on; 1 cold round, 2 warm,
# then the client vmap against the loop in turns
NNU_CLIENTS, NNU_VOLUMES, NNU_SIZE, NNU_PATCHES, NNU_TRAIN = 2, 4, 128, 10, 8
NNU_STEPS, NNU_LR, NNU_WARM, NNU_AXIS_ROUNDS = 4, 5e-3, 2, 4
NNU_ROUNDS = 1 + NNU_WARM + 1 + NNU_AXIS_ROUNDS  # a profiled round too
NNU_FEATURES = [32, 64, 128, 256, 320, 320]
# the nnunet_synthetic smoke config's size: 12^3 volumes, features / 4
TINY_NNU_SIZE = 12
RNG_SHAPES = [(), (7,), (64,), (3, 5, 11), (579402,)]
# CifarNet's parameter leaves, each with a leading per-example axis on the path
CIFAR_LEAVES = {"Conv_0/kernel": (5, 5, 3, 32), "Conv_0/bias": (32,),
                "Conv_1/kernel": (5, 5, 32, 64), "Conv_1/bias": (64,),
                "Dense_0/kernel": (4096, 128), "Dense_0/bias": (128,),
                "Dense_1/kernel": (128, 10), "Dense_1/bias": (10,)}


def fail(msg: str) -> None:
    raise RuntimeError(f"chip_smoke: {msg}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()


def cuda_ms(fn, reps: int = 7, warmup: int = 2, calls: int = 1) -> float:
    """Median over ``reps`` CUDA-event timings of ``calls`` back-to-back
    calls, per call, in ms. A spin kernel (~10 ms) runs ahead of the start
    event, so the host has enqueued every call before the device reaches
    it: the time is the device's, without the host's launch latency (which
    is most of a 20-microsecond kernel's call)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        torch.cuda._sleep(20_000_000)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def check(name: str, got: torch.Tensor, want: torch.Tensor, atol: float,
          rtol: float) -> float:
    """max |got - want|; fails where |got - want| > atol + rtol |want|."""
    return check_stats(name, got, want, atol, rtol)["max_abs_err"]


def check_stats(name: str, got: torch.Tensor, want: torch.Tensor, atol: float,
                rtol: float) -> dict:
    """As ``check``, with the size of the values held and the largest share
    of the bound that an element used."""
    return check_bound(name, got, want, atol + rtol * want.float().abs(),
                       f"atol={atol} rtol={rtol}")


def check_bound(name: str, got: torch.Tensor, want: torch.Tensor,
                bound: torch.Tensor, what: str = "the derived bound") -> dict:
    """Fails where |got - want| exceeds the per-element ``bound``."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    if not torch.isfinite(got).all():
        fail(f"{name}: non-finite values")
    bad = diff > bound
    if bad.any():
        fail(f"{name}: {int(bad.sum())} elements beyond {what}, "
             f"max abs err {float(diff.max()):.3e}")
    return {"max_abs_err": float(diff.max()), "mean_abs_ref": float(want.abs().mean()),
            "max_abs_ref": float(want.abs().max()),
            "bound_used": float((diff / bound).max())}


def inline_rounds(sim, rounds: int) -> None:
    """``rounds`` more rounds through the pipeline's plain version: each
    round's epilogue (and so its pull, which waits for the device) inline,
    no consumer, no prefetcher."""
    val_batches, val_counts = sim._val_batches()
    first = len(sim.history) + 1
    for rnd in range(first, first + rounds):
        sim._run_round(rnd, val_batches, val_counts)


def pipeline_walls(sim, rounds: int = WARM_ROUNDS) -> dict:
    """Synchronised walls of ``rounds`` warm rounds through the pipelined
    ``fit`` (``execution_mode`` pinned to it) and through ``inline_rounds``,
    in turns."""
    walls = {"pipelined_s": [], "inline_s": []}
    mode_before = sim.execution_mode
    for mode in ("pipelined", "inline", "inline", "pipelined"):
        torch.cuda.synchronize()
        t0 = time.time()
        if mode == "pipelined":
            sim.execution_mode = "pipelined"
            sim.fit(rounds)
            sim.execution_mode = mode_before
        else:
            inline_rounds(sim, rounds)
        torch.cuda.synchronize()
        walls[f"{mode}_s"].append(time.time() - t0)
    return {"rounds": rounds, **walls}


def mode_walls(sim, rounds: int = WARM_ROUNDS) -> dict:
    """Synchronised walls of ``rounds`` warm rounds through ``fit`` on the
    chunked and the pipelined route, in turns."""
    walls = {"chunked_s": [], "pipelined_s": []}
    mode_before = sim.execution_mode
    for mode in ("chunked", "pipelined", "pipelined", "chunked"):
        sim.execution_mode = mode
        torch.cuda.synchronize()
        t0 = time.time()
        sim.fit(rounds)
        torch.cuda.synchronize()
        walls[f"{mode}_s"].append(time.time() - t0)
    sim.execution_mode = mode_before
    return {"rounds": rounds, **walls}


def attention_inputs(b: int, t: int, dtype: torch.dtype, seed: int, d: int = D,
                     h: int = H):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (torch.randn((b, t, h, d), generator=g, device="cuda").to(dtype)
                   for _ in range(4))
    dlse = torch.randn((b, h, t), generator=g, device="cuda")
    lengths = np.random.default_rng(seed).integers(t // 2, t + 1, size=b)
    lengths[-1] = 0  # one batch element with no real key
    mask = (torch.arange(t)[None, :] < torch.tensor(lengths)[:, None]).float().cuda()
    return q, k, v, mask, do, dlse


def plain_grads(fa, q, k, v, mask, do, dlse, out) -> tuple:
    """``([dq, dk, dv], lse, delta)`` of (out, lse) under cotangents (do,
    dlse), by the plain version in f32. f32: autograd through it (no lse or
    delta returned). bf16: the kernels' contract
    hands out O in bf16 and the backward reads delta = rowsum(dO O) - dlse
    from that O (as the JAX ``_bwd_call`` does); the tensor-core forward's O
    differs from the plain one's by its rounding of P, which would move dq
    and dk through delta by more than the kernels' own error. So the plain
    backward reads delta from ``out``, the O the kernel path handed out, and
    is in f32 otherwise."""
    if q.dtype == torch.float32:
        leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
        o, lse = fa.flash_attention_reference(*leaves, mask)
        torch.autograd.backward([o, lse], [do, dlse])
        return [x.grad for x in leaves], None, None
    with torch.no_grad():
        _, lse = fa.flash_attention_reference(q, k, v, mask)
        delta = fa.backward_delta(do, out, dlse)
        qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
        return [fa.flash_bwd_dq_reference(qf, kf, vf, mask, dof, lse, delta),
                *fa.flash_bwd_dkv_reference(qf, kf, vf, mask, dof, lse, delta)], lse, delta


def kernel_checks(fa, b: int, t: int, dtype: torch.dtype, seed: int,
                  autograd_check: bool, d: int = D) -> dict:
    """Each kernel against its plain version on the same inputs; returns the
    max abs errors and prints them with the size of the values held and the
    share of each bound used. On the tensor-core route the first slice's
    CUDA-core forward, dQ and dK/dV (which bf16 at other head dims still
    takes) are held to TOL on the same inputs too."""
    tol = TOL[dtype]
    g_atol, g_rtol = tol["grad"]
    q, k, v, mask, do, dlse = attention_inputs(b, t, dtype, seed, d)
    tensor_cores = fa.wgmma_route(q)
    tag = f"{str(dtype).split('.')[-1]} B={b} T={t}" + (f" d={d}" if d != D else "")

    def bounds(*args):
        """out, dq, dk, dv bounds: the derived ones on the tensor-core route."""
        if not tensor_cores:
            return None
        return fa.bf16_operand_bounds(*args, atol=tol["out"][0], rtol=tol["out"][1])

    def held(name, got, want, bnd, key, atol, rtol):
        if bnd is None:
            return check_stats(name, got, want, atol, rtol)
        return check_bound(name, got, want, bnd[key])

    with torch.no_grad():
        qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
        out, lse = fa.flash_fwd(q, k, v, mask)
        ref_out, ref_lse = fa.flash_attention_reference(qf, kf, vf, mask)
        if not torch.all(out[-1] == 0):
            fail(f"{tag}: a row with no real key must give out = 0")
        stats = {"out": held(f"fwd out {tag}", out, ref_out, bounds(qf, kf, vf, mask),
                             "out", *tol["out"]),
                 "lse": check_stats(f"fwd lse {tag}", lse, ref_lse, *tol["lse"])}
        delta = fa.backward_delta(do, out, dlse)
        if tensor_cores:
            core_fwd, core_dq, core_dkv, core = cuda_core_launchers(fa, q, k, v, mask, do,
                                                                    lse, delta)
            core_fwd()
            stats["cuda_core_out"] = check_stats(f"CUDA-core fwd out {tag}", core["out"],
                                                 ref_out, *tol["out"])
            stats["cuda_core_lse"] = check_stats(f"CUDA-core fwd lse {tag}", core["lse"],
                                                 ref_lse, *tol["lse"])
        del ref_out, ref_lse
        bnd = bounds(qf, kf, vf, mask, dof, lse, delta)
        dq = fa.flash_bwd_dq(q, k, v, mask, do, lse, delta)
        ref = fa.flash_bwd_dq_reference(qf, kf, vf, mask, dof, lse, delta)
        stats["dq"] = held(f"dq {tag}", dq, ref, bnd, "dq", g_atol, g_rtol)
        if tensor_cores:
            # no atomics and each row written once: a second launch is bit-identical
            if not torch.equal(dq, fa.flash_bwd_dq(q, k, v, mask, do, lse, delta)):
                fail(f"dq {tag}: a second launch differs from the first")
            core_dq()
            stats["cuda_core_dq"] = check_stats(f"CUDA-core dq {tag}", core["dq"], ref,
                                                g_atol, g_rtol)
        del ref
        dk, dv = fa.flash_bwd_dkv(q, k, v, mask, do, lse, delta)
        ref_dk, ref_dv = fa.flash_bwd_dkv_reference(qf, kf, vf, mask, dof, lse, delta)
        stats["dk"] = held(f"dk {tag}", dk, ref_dk, bnd, "dk", g_atol, g_rtol)
        stats["dv"] = held(f"dv {tag}", dv, ref_dv, bnd, "dv", g_atol, g_rtol)
        if tensor_cores:
            core_dkv()
            stats["cuda_core_dk"] = check_stats(f"CUDA-core dk {tag}", core["dk"], ref_dk,
                                                g_atol, g_rtol)
            stats["cuda_core_dv"] = check_stats(f"CUDA-core dv {tag}", core["dv"], ref_dv,
                                                g_atol, g_rtol)
            del core
        del ref_dk, ref_dv, dq, dk, dv, bnd
    if autograd_check:
        # the autograd.Function end to end (forward kernel, delta, both
        # backward kernels) against the plain version's gradients
        leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
        o, l_ = fa._FlashAttention.apply(*leaves, mask)
        torch.autograd.backward([o.float(), l_], [do.float(), dlse])
        got = [x.grad for x in leaves]
        want, p_lse, p_delta = plain_grads(fa, q, k, v, mask, do, dlse, o.detach())
        with torch.no_grad():
            bnd = bounds(qf, kf, vf, mask, dof, p_lse, p_delta)
        del o, l_, leaves
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            stats[f"autograd_{name}"] = held(f"autograd {name} {tag}", g, w, bnd, name,
                                             g_atol, g_rtol)
        del got, want, bnd
    worst = lambda *names: max(stats[n]["max_abs_err"] for n in names)  # noqa: E731
    err = {"flash_fwd": worst("out", "lse"), "flash_bwd_dq": worst("dq"),
           "flash_bwd_dkv": worst("dk", "dv")}
    share = {n: max(stats[x]["bound_used"] for x in xs) for n, xs in
             (("flash_fwd", ("out", "lse")), ("flash_bwd_dq", ("dq",)),
              ("flash_bwd_dkv", ("dk", "dv")))}
    if tensor_cores:
        err["cuda_core"] = {"flash_fwd": worst("cuda_core_out", "cuda_core_lse"),
                            "flash_bwd_dq": worst("cuda_core_dq"),
                            "flash_bwd_dkv": worst("cuda_core_dk", "cuda_core_dv")}
    print(json.dumps({"check": tag, "tensor_cores": tensor_cores, "max_abs_err": err,
                      "bound_used": share, "stats": stats,
                      "tolerance": {name: list(b) for name, b in tol.items()},
                      "derived_bounds": ["out", "dq", "dk", "dv"] if tensor_cores else []}))
    torch.cuda.empty_cache()
    return {"max_abs_err": err, "bound_used": share}


def bound_ms(ops: float, nbytes: float, dtype: torch.dtype) -> tuple[float, str]:
    t_ops, t_bytes = ops / PEAK_OPS[dtype], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def cuda_core_launchers(fa, q, k, v, mask, do, lse, delta):
    """The first slice's CUDA-core forward, dQ and dK/dV kernels on the same
    inputs (the route bf16 at D=64 took before the tensor-core kernels),
    launched through the extension directly, to check and time beside them:
    ``(fwd, dq, dkv, outputs)``, where each launch writes ``outputs``' out
    and lse, dq, or dk and dv."""
    ext, (b, t, h, d) = fa.build_extension(), q.shape
    bf16, stream = q.dtype == torch.bfloat16, torch.cuda.current_stream().cuda_stream
    out, lse_out = torch.empty_like(q), torch.empty_like(lse)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    # the [B, T] mask as one block of B rows (csrc/flash_mask.cuh)
    ptrs = [*(x.data_ptr() for x in (q, k, v, mask)), b, 0]
    bwd = [do.data_ptr(), lse.data_ptr(), delta.data_ptr()]

    def fwd():
        if ext.fwd(*ptrs, out.data_ptr(), lse_out.data_ptr(), b, t, h, d, d ** -0.5,
                   bf16, stream):
            fail("CUDA-core forward launch failed")

    def bwd_dq():
        if ext.bwd_dq(*ptrs, *bwd, dq.data_ptr(), b, t, h, d, d ** -0.5, bf16, stream):
            fail("CUDA-core dQ launch failed")

    def dkv():
        if ext.bwd_dkv(*ptrs, *bwd, dk.data_ptr(), dv.data_ptr(), b, t, h, d, d ** -0.5,
                       bf16, stream):
            fail("CUDA-core dK/dV launch failed")
    return fwd, bwd_dq, dkv, {"out": out, "lse": lse_out, "dq": dq, "dk": dk, "dv": dv}


def kernel_timings(fa, dtype: torch.dtype, clients: int = 1, batch: int = B, t: int = T,
                   h: int = H) -> dict:
    """Kernel, plain version and SDPA times at a main path's shapes
    (transformer_long's by default). With ``clients`` > 1, the shape the
    client vmap hands every launch on the path: the clients' batches folded
    into one, ``[clients * batch, t, h, D]``, the mask a ``[clients, batch,
    t]`` stack of each client's rows. With 1, one client's batch, beside the
    first slice's CUDA-core kernels on the same inputs."""
    b = clients * batch
    q, k, v, mask, do, dlse = attention_inputs(b, t, dtype, seed=11, h=h)
    stack = mask.view(clients, batch, t) if clients > 1 else mask
    es = q.element_size()
    n, rows = q.numel(), b * h * t
    # query rows x real keys, over batch and heads: the work this data needs
    pairs = float(t * h * mask.sum())
    small = mask.numel() * 4 + rows * 4  # mask + one [B,H,T] f32 vector
    with torch.no_grad():
        out, lse = fa.flash_fwd(q, k, v, stack)
        delta = fa.backward_delta(do, out, dlse)
        qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        key_ok = (mask > 0)[:, None, None, :]
        core = (cuda_core_launchers(fa, q, k, v, mask, do, lse, delta) if clients == 1
                else None)
        res = {
            "flash_fwd": dict(
                ms=cuda_ms(lambda: fa.flash_fwd(q, k, v, stack)),
                plain_ms=cuda_ms(lambda: fa.flash_attention_reference(q, k, v, mask), reps=3),
                library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                    qh, kh, vh, attn_mask=key_ok)),
                cuda_core_ms=cuda_ms(core[0]) if core else None,
                bound=bound_ms(4 * D * pairs, 4 * n * es + small, dtype)),
            "flash_bwd_dq": dict(
                ms=cuda_ms(lambda: fa.flash_bwd_dq(q, k, v, stack, do, lse, delta)),
                plain_ms=cuda_ms(lambda: fa.flash_bwd_dq_reference(
                    q, k, v, mask, do, lse, delta), reps=3),
                library_ms=None,  # no library call computes dQ alone
                cuda_core_ms=cuda_ms(core[1]) if core else None,
                bound=bound_ms(6 * D * pairs, 5 * n * es + small + rows * 4, dtype)),
            "flash_bwd_dkv": dict(
                ms=cuda_ms(lambda: fa.flash_bwd_dkv(q, k, v, stack, do, lse, delta)),
                plain_ms=cuda_ms(lambda: fa.flash_bwd_dkv_reference(
                    q, k, v, mask, do, lse, delta), reps=3),
                library_ms=None,  # nor dK and dV alone
                cuda_core_ms=cuda_ms(core[2]) if core else None,
                bound=bound_ms(8 * D * pairs, 6 * n * es + small + rows * 4, dtype)),
        }
        del core
        torch.cuda.empty_cache()
    # SDPA's backward computes dQ, dK and dV in one call: a yardstick for
    # flash_bwd_dq + flash_bwd_dkv together
    leaves = [x.detach().requires_grad_(True) for x in (qh, kh, vh)]
    o = F.scaled_dot_product_attention(*leaves, attn_mask=key_ok)
    doh = do.transpose(1, 2).contiguous()
    sdpa_bwd = cuda_ms(lambda: torch.autograd.grad(o, leaves, doh, retain_graph=True))
    print(json.dumps({"timing": str(dtype).split(".")[-1], "shape": [b, t, h, D],
                      "mask_blocks": clients,
                      **{k: {kk: vv for kk, vv in r.items()} for k, r in res.items()},
                      "sdpa_backward_ms": sdpa_bwd,
                      "kernels_backward_ms": res["flash_bwd_dq"]["ms"]
                      + res["flash_bwd_dkv"]["ms"]}))
    del o, leaves
    torch.cuda.empty_cache()
    res["flash_bwd_dq"]["library_dqkv_ms"] = sdpa_bwd
    res["flash_bwd_dkv"]["library_dqkv_ms"] = sdpa_bwd
    return res


def vmapped_kernel_checks(fa, seed: int, n: int = N_CLIENTS, batch: int = B, t: int = T,
                          h: int = H) -> dict:
    """K3-K5 at the shape the client vmap hands them on the main path:
    bf16 ``[N_CLIENTS * B, T, H, D]`` (both clients' batches folded), the key
    mask an ``[N_CLIENTS, B, T]`` stack of row blocks read through its block
    stride (csrc/flash_mask.cuh). Three stacks: each client its own rows
    (block stride B*T, as the main path's), one mask that both clients share
    (stride 0: a mask the vmap did not batch) and blocks inside a wider
    buffer (stride (B + 16)*T). Each kernel's output, launched on the folded
    inputs directly and through the Functions' vmap rules
    (``torch.func.vmap`` over the clients of ``vjp`` of
    ``flash_attention_lse``, as the main path differentiates it), is held per
    client against the plain version on that client's rows and mask: out, dq,
    dk and dv to ``bf16_operand_bounds``, lse to TOL. The defaults are
    transformer_long's shapes; bert_lora_fedopt_base passes its own."""
    bn, tol = n * batch, TOL[torch.bfloat16]
    q, k, v, mask, do, dlse = attention_inputs(bn, t, torch.bfloat16, seed, h=h)
    own = mask.view(n, batch, t)
    wide = torch.zeros((n, batch + 16, t), device="cuda")
    wide[:, :batch] = own
    # the shared mask: client 1's rows, which hold the row with no real key
    stacks = {"own": own, "strided": wide[:, :batch],
              "shared": own[1][None].expand(n, batch, t)}

    def one_client(q, k, v, m, do, dl):
        (o, l_), pull = torch.func.vjp(lambda *x: fa.flash_attention_lse(*x, m), q, k, v)
        return (o, l_, *pull((do, dl)))

    per_client = lambda x: x.view(n, batch, *x.shape[1:])  # noqa: E731
    got = {}
    for name, stack in stacks.items():
        with torch.no_grad():
            out, lse = fa.flash_fwd(q, k, v, stack)
            delta = fa.backward_delta(do, out, dlse)
            direct = (out, lse, fa.flash_bwd_dq(q, k, v, stack, do, lse, delta),
                      *fa.flash_bwd_dkv(q, k, v, stack, do, lse, delta))
        shared = name == "shared"
        vmapped = torch.func.vmap(one_client, in_dims=(0, 0, 0, None if shared else 0, 0, 0),
                                  randomness="error")(
            *(per_client(x) for x in (q, k, v)), stack[0] if shared else stack,
            per_client(do), per_client(dlse))
        got[name] = {"kernels": direct,
                     "vmap": tuple(x.reshape(bn, *x.shape[2:]) for x in vmapped),
                     "delta": delta}
    stats, names = {}, ("out", "lse", "dq", "dk", "dv")
    for c in range(n):
        rows = slice(c * batch, (c + 1) * batch)
        qf, kf, vf, dof = (x[rows].float() for x in (q, k, v, do))
        # own and strided hold the same values: one plain version serves both
        for mask_of, which in ((own[c], ("own", "strided")), (own[1], ("shared",))):
            with torch.no_grad():
                ref_out, ref_lse = fa.flash_attention_reference(qf, kf, vf, mask_of)
            for name in which:
                for path in ("kernels", "vmap"):
                    outs = [x[rows] for x in got[name][path]]
                    lse, delta = outs[1], fa.backward_delta(do[rows], outs[0], dlse[rows])
                    with torch.no_grad():
                        bnd = fa.bf16_operand_bounds(qf, kf, vf, mask_of, dof, lse, delta,
                                                     atol=tol["out"][0], rtol=tol["out"][1])
                        refs = (ref_out, ref_lse,
                                fa.flash_bwd_dq_reference(qf, kf, vf, mask_of, dof, lse,
                                                          delta),
                                *fa.flash_bwd_dkv_reference(qf, kf, vf, mask_of, dof, lse,
                                                            delta))
                    for out_name, x, ref in zip(names, outs, refs):
                        tag = f"vmapped {path} {out_name} mask={name} client={c}"
                        stats[(path, name, c, out_name)] = (
                            check_stats(tag, x, ref, *tol["lse"]) if out_name == "lse"
                            else check_bound(tag, x, ref, bnd[out_name]))
                    del bnd, refs
                    torch.cuda.empty_cache()
    kernel_of = {"flash_fwd": ("out", "lse"), "flash_bwd_dq": ("dq",),
                 "flash_bwd_dkv": ("dk", "dv")}
    err = {k: max(v["max_abs_err"] for (_, _, _, o), v in stats.items() if o in outs)
           for k, outs in kernel_of.items()}
    share = {k: max(v["bound_used"] for (_, _, _, o), v in stats.items() if o in outs)
             for k, outs in kernel_of.items()}
    same = {name: all(torch.equal(a, b) for a, b in zip(g["kernels"], g["vmap"]))
            for name, g in got.items()}
    print(json.dumps({"check": "K3-K5 at the vmapped shape", "shape": [bn, t, h, D],
                      "mask_stacks": {k: list(m.stride()) for k, m in stacks.items()},
                      "max_abs_err": err, "bound_used": share,
                      "vmap_rules_bit_identical_to_direct_launches": same,
                      "by_mask": {name: {path: {o: max(v["max_abs_err"] for (p, m, _, oo), v
                                                       in stats.items()
                                                       if (p, m, oo) == (path, name, o))
                                                for o in names}
                                         for path in ("kernels", "vmap")}
                                  for name in stacks}}))
    del got
    torch.cuda.empty_cache()
    return {"max_abs_err": err, "bound_used": share}


def build_sim(modules, datasets, dtype, device, seed, attention_fn=None, **sim_kw):
    from fl4health_tpu_torch import optim
    from fl4health_tpu_torch.clients import engine
    from fl4health_tpu_torch.kernels.flash_attention import flash_attention
    from fl4health_tpu_torch.metrics import efficient
    from fl4health_tpu_torch.metrics.base import MetricManager
    from fl4health_tpu_torch.models.transformer import TransformerClassifier
    from fl4health_tpu_torch.server.simulation import FederatedSimulation
    from fl4health_tpu_torch.strategies.fedavg import FedAvg

    module = TransformerClassifier(
        **modules, dtype=dtype, remat=True,
        attention_fn=attention_fn or flash_attention)
    return FederatedSimulation(
        logic=engine.ClientLogic(engine.from_module(module), engine.masked_cross_entropy),
        tx=optim.sgd(0.05), strategy=FedAvg(), datasets=datasets, batch_size=BATCH,
        metrics=MetricManager((efficient.accuracy(),)), local_steps=LOCAL_STEPS,
        seed=seed, device=device, **sim_kw)


def text_datasets(vocab: int, seq: int, n_rows: int, n_train: int):
    """Client i's rows from ``PRNGKey(i)``, drawn on the card as the JAX
    generator draws them, kept on the host as the simulation takes them."""
    from fl4health_tpu_torch import rng
    from fl4health_tpu_torch.datasets.synthetic import synthetic_text_classification
    from fl4health_tpu_torch.server.simulation import ClientDataset

    out = []
    for i in range(N_CLIENTS):
        x, y = (a.cpu() for a in synthetic_text_classification(
            rng.PRNGKey(i, "cuda"), n_rows, vocab, seq, 4))
        out.append(ClientDataset(x[:n_train], y[:n_train], x[n_train:], y[n_train:]))
    return out


def tiny_parity() -> None:
    """The same tiny federated run on the card (kernels) and on the CPU
    (plain version), from the same params."""
    cfg = dict(vocab_size=64, n_classes=4, d_model=64, n_heads=2, n_layers=2,
               d_ff=128, max_len=80)
    data = text_datasets(64, 80, 48, 40)
    res = card_vs_cpu("tiny", lambda device: build_sim(cfg, data, torch.float32, device,
                                                        seed=3), 2)
    print(json.dumps({"tiny_parity": "cuda kernels vs cpu plain", **res}))


def bf16_model_check(fa) -> dict:
    """The tiny transformer at head dim 64 in bf16 compute, 2 rounds on the
    card through the kernels (tensor-core forward and dK/dV) and through the
    plain version, and the plain version in f32 compute, all from the same
    params: the kernels may move the losses and the params by no more than
    bf16 compute moves the plain run."""
    cfg = dict(vocab_size=64, n_classes=4, d_model=128, n_heads=2, n_layers=2,
               d_ff=256, max_len=80)
    data = text_datasets(64, 80, 48, 40)

    def plain(q, k, v, pad_mask=None):
        return fa.flash_attention_reference(q, k, v, pad_mask)[0]

    runs, init = {}, None
    for name, dtype, attn in (("kernels_bf16", torch.bfloat16, None),
                              ("plain_bf16", torch.bfloat16, plain),
                              ("plain_f32", torch.float32, plain)):
        sim = build_sim(cfg, data, dtype, "cuda", seed=3, attention_fn=attn)
        if init is None:
            init = {k: v.clone() for k, v in sim.global_params.items()}
        sim.set_global_params({k: v.clone() for k, v in init.items()})
        fa.reset_launch_counts()
        hist = sim.fit(2)
        torch.cuda.synchronize()
        losses = torch.tensor([x for r in hist for x in (r.fit_losses["backward"],
                                                         r.eval_losses["checkpoint"])])
        runs[name] = (losses, sim.global_params, dict(fa.WGMMA_LAUNCHES))
    if min(runs["kernels_bf16"][2].values()) == 0:
        fail(f"bf16 model check: the tensor-core kernels never ran {runs['kernels_bf16'][2]}")
    if max(runs["plain_bf16"][2].values()) != 0:
        fail("bf16 model check: the plain run launched kernels")

    def gap(a, b):
        la, pa, _ = runs[a]
        lb, pb, _ = runs[b]
        return (float((la - lb).abs().max()),
                max(float((pa[k] - pb[k]).abs().max()) for k in pa))
    kernels, bf16 = gap("kernels_bf16", "plain_bf16"), gap("plain_bf16", "plain_f32")
    res = {"bf16_model_check": "tiny transformer, head dim 64, 2 rounds",
           "kernels_vs_plain_bf16": {"loss": kernels[0], "param": kernels[1]},
           "plain_bf16_vs_plain_f32": {"loss": bf16[0], "param": bf16[1]},
           "losses": {k: v[0].tolist() for k, v in runs.items()},
           "wgmma_launches": runs["kernels_bf16"][2]}
    print(json.dumps(res))
    if not all(np.isfinite(runs[k][0].numpy()).all() for k in runs):
        fail("bf16 model check: non-finite losses")
    if kernels[0] > bf16[0] or kernels[1] > bf16[1]:
        fail(f"bf16 model check: the kernels move (loss, param) by {kernels}, "
             f"more than bf16 compute does {bf16}")
    return res


def main_path(fa) -> dict:
    """Full-width transformer_long federated training, bf16 compute."""
    cfg = dict(vocab_size=8192, n_classes=4, d_model=512, n_heads=8, n_layers=4,
               d_ff=2048, max_len=T)
    data = text_datasets(8192, T, BATCH * LOCAL_STEPS + 16, BATCH * LOCAL_STEPS)
    sim = build_sim(cfg, data, torch.bfloat16, "cuda", seed=0)
    init = {k: v.clone() for k, v in sim.global_params.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    t0 = time.time()
    hist = sim.fit(ROUNDS)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches, wgmma = dict(fa.LAUNCHES), dict(fa.WGMMA_LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    positions = N_CLIENTS * LOCAL_STEPS * BATCH * T
    real = sum(int((d.x_train > 0).sum()) for d in data)  # one pass over each client's rows
    for r in hist:
        if not all(np.isfinite(v) for v in (*r.fit_losses.values(),
                                              *r.eval_losses.values())):
            fail(f"round {r.round}: non-finite losses {r.fit_losses} {r.eval_losses}")
        print(json.dumps({
            "round": r.round, "fit_loss": r.fit_losses["backward"],
            "eval_loss": r.eval_losses["checkpoint"],
            "eval_accuracy": r.eval_metrics["accuracy"],
            "fit_dispatch_s": r.fit_elapsed_s, "eval_dispatch_s": r.eval_elapsed_s}))
    moved = max(float((sim.global_params[k] - init[k]).abs().max()) for k in init)
    finite = all(torch.isfinite(v).all() for v in sim.global_params.values())
    if not finite or moved <= 0:
        fail(f"global params after training: finite={finite}, max change {moved}")
    walls = pipeline_walls(sim)
    warm = walls["pipelined_s"]
    # per round, the clients folded into each launch by the vmap rules:
    # 5 steps x 4 layers (x2 for the remat recompute) + one eval step
    expected = {
        "flash_fwd": ROUNDS * (LOCAL_STEPS * 4 * 2 + 4),
        "flash_bwd_dq": ROUNDS * LOCAL_STEPS * 4,
        "flash_bwd_dkv": ROUNDS * LOCAL_STEPS * 4,
    }
    print(json.dumps({"main_path": "transformer_long", "rounds": ROUNDS, "wall_s": wall,
                      "warm_walls": walls,
                      # per second of synchronised round wall (fit and eval)
                      "train_token_positions_per_s": [
                          WARM_ROUNDS * positions / w for w in warm],
                      "train_real_tokens_per_s": [WARM_ROUNDS * real / w for w in warm],
                      "n_params": sum(v.numel() for v in init.values()),
                      "peak_mem_gib": peak,
                      "max_param_change": moved, "launches": launches,
                      "expected_launches": expected, "wgmma_launches": wgmma}))
    if launches != expected:
        fail(f"main-path launches {launches}, expected {expected}")
    # bf16 at head dim 64: every launch of all three kernels took the tensor cores
    if wgmma != launches:
        fail(f"main-path tensor-core launches {wgmma}, expected all of {launches}")
    return launches


def dp_tree(shapes: dict, b: int, dtype: torch.dtype, seed: int,
            grad_scale: bool = False) -> dict:
    """Per-example gradients [b, *shape] on the card: unit normals (as the
    JAX kernel tests draw them), or with ``grad_scale`` times a per-example
    scale from 0.5e-3 to 2.5e-3, so that at the CifarNet tree's width C = 1
    clips some examples and not others."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    row = (torch.linspace(0.5e-3, 2.5e-3, b, device="cuda") if grad_scale
           else torch.ones(b, device="cuda"))
    return {k: (torch.randn((b, *s), generator=g, device="cuda")
                * row.view(b, *[1] * len(s))).to(dtype) for k, s in shapes.items()}


def fused_plain(dp, tree: dict, mask: torch.Tensor, bound: float):
    """The fused clip and sum, composed of the plain versions."""
    mats = {k: v.reshape(v.shape[0], -1) for k, v in tree.items()}
    norms = torch.sqrt(sum(dp.per_example_sq_norms_reference(m) for m in mats.values()))
    scale = torch.clamp(bound / torch.clamp(norms, min=1e-12), max=1.0) * mask
    return {k: dp.scaled_masked_sum_reference(m, scale).reshape(tree[k].shape[1:])
            for k, m in mats.items()}, norms


def dp_kernel_checks(dp, dtype: torch.dtype) -> dict:
    """K1 (over each case's tree, and on each leaf alone), K2 and the fused
    clip against their plain versions at the largest leaf, over the whole
    CifarNet tree and at a ragged width (K1 and K2 on unit normals, the fused
    clip on gradient-sized values that C = 1 clips in part); returns the max
    abs error of each kernel at the largest leaf."""
    tag = str(dtype).split(".")[-1]
    stats, at_leaf = {}, {}
    cases = {"leaf": {"Dense_0/kernel": (524288,)}, "tree": CIFAR_LEAVES,
             "ragged": {"w": (1000,)}}
    for case, shapes in cases.items():
        b = 7 if case == "ragged" else BATCH
        tree = dp_tree(shapes, b, dtype, seed=len(stats) + 21)
        grads = dp_tree(shapes, b, dtype, seed=len(stats) + 22, grad_scale=True)
        mask = torch.ones(b, device="cuda")
        mask[1] = 0.0  # a padding example
        scale = torch.rand(b, device="cuda") * 1.5 * mask
        with torch.no_grad():
            mats = [leaf.reshape(b, -1) for leaf in tree.values()]
            got = dp.sq_norms_tree_kernel(mats)
            stats[f"dp_sq_norms tree of {case} {tag}"] = check_stats(
                f"dp_sq_norms tree of {case} {tag}", got,
                dp.per_example_tree_sq_norms_reference(mats), *DP_TOL["dp_sq_norms"])
            # items write fixed slots and the last CTA sums them in a fixed
            # order: a second launch is bit-identical
            if not torch.equal(got, dp.sq_norms_tree_kernel(mats)):
                fail(f"dp_sq_norms tree of {case} {tag}: a second launch differs")
            for k, m in zip(tree, mats):
                name = f"{case} {k} {tag} {list(m.shape)}"
                stats[f"dp_sq_norms {name}"] = check_stats(
                    f"dp_sq_norms {name}", dp.sq_norms_tree_kernel([m]),
                    dp.per_example_sq_norms_reference(m), *DP_TOL["dp_sq_norms"])
                got = dp.scaled_sum_kernel(m, scale)
                stats[f"dp_scaled_sum {name}"] = check_stats(
                    f"dp_scaled_sum {name}", got,
                    dp.scaled_masked_sum_reference(m, scale), *DP_TOL["dp_scaled_sum"])
                # a fixed order on both routes: a second launch is bit-identical
                if not torch.equal(got, dp.scaled_sum_kernel(m, scale)):
                    fail(f"dp_scaled_sum {name}: a second launch differs from the first")
                if case == "leaf":
                    at_leaf = {n: stats[f"{n} {name}"]["max_abs_err"]
                               for n in ("dp_sq_norms", "dp_scaled_sum")}
            got, norms = dp.fused_clipped_masked_sum(grads, mask, DP_CLIP, return_norms=True)
            want, want_norms = fused_plain(dp, grads, mask, DP_CLIP)
            stats[f"fused norms {case} {tag}"] = check_stats(
                f"fused norms {case} {tag}", norms, want_norms, *DP_TOL["dp_sq_norms"])
            for k in want:
                stats[f"fused {case} {k} {tag}"] = check_stats(
                    f"fused {case} {k} {tag}", got[k], want[k], *DP_TOL["fused"])
            if case == "tree":
                clipped = int(((want_norms > DP_CLIP) * mask).sum())
                if not 0 < clipped < int(mask.sum()):
                    fail(f"tree check clips {clipped} examples: it must clip some, not all")
        del tree, grads
    print(json.dumps({"check": f"dp_clip {tag}",
                      "max_abs_err": {k: v["max_abs_err"] for k, v in stats.items()},
                      "bound_used": max(v["bound_used"] for v in stats.values()),
                      "tolerance": {k: list(v) for k, v in DP_TOL.items()}}))
    torch.cuda.empty_cache()
    return at_leaf


def dp_kernel_timings(dp) -> dict:
    """K1 and K2 at the DP path's largest leaf and over its whole per-example
    tree (f32, as the path gives them), beside their plain versions and a
    library call computing the same function (a yardstick the port never
    calls); device time per call, 20 calls a timing. K1 over the tree is one
    call, as the path makes it (its library yardstick: ``vector_norm`` per
    leaf, stacked, squared and summed); K2 is one call per leaf. Bounds:
    bytes in and out once over 3.35 TB/s, against two f32 operations per
    element over the f32 rate."""
    res = {}
    time_it = lambda fn: cuda_ms(fn, calls=20)  # noqa: E731
    for case, shapes in (("leaf", {"Dense_0/kernel": (524288,)}), ("tree", CIFAR_LEAVES)):
        tree = dp_tree(shapes, BATCH, torch.float32, seed=31, grad_scale=True)
        mats = [v.reshape(BATCH, -1) for v in tree.values()]
        scale = torch.rand(BATCH, device="cuda")
        widths = [m.shape[1] for m in mats]
        elems = BATCH * sum(widths)
        k1_bytes = 4 * elems + 4 * BATCH
        k2_bytes = 4 * elems + 4 * BATCH * len(mats) + 4 * sum(widths)
        if case == "leaf":
            k1_library = lambda: torch.linalg.vector_norm(  # noqa: E731
                mats[0], dim=1, dtype=torch.float32)
        else:
            k1_library = lambda: torch.stack([torch.linalg.vector_norm(  # noqa: E731
                m, dim=1, dtype=torch.float32) for m in mats]).square().sum(0)
        with torch.no_grad():
            res[case] = {
                "dp_sq_norms": dict(
                    ms=time_it(lambda: dp.sq_norms_tree_kernel(mats)),
                    plain_ms=time_it(lambda: dp.per_example_tree_sq_norms_reference(mats)),
                    library_ms=time_it(k1_library),
                    bound=bound_ms(2 * elems, k1_bytes, torch.float32)),
                "dp_scaled_sum": dict(
                    ms=time_it(lambda: [dp.scaled_sum_kernel(m, scale) for m in mats]),
                    plain_ms=time_it(lambda: [dp.scaled_masked_sum_reference(m, scale)
                                              for m in mats]),
                    library_ms=time_it(lambda: [torch.mv(m.t(), scale) for m in mats]),
                    bound=bound_ms(2 * elems, k2_bytes, torch.float32)),
            }
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        (plan,) = dp.plan_of(mats)
        res[case]["dp_sq_norms"]["geometry"] = {
            "items": plan.n_items,  # one CTA each
            # per leaf: (rows, column chunks) of an item
            "rows_x_chunks": [[lf.rows, lf.n_chunks] for lf in plan.leaves]}
        print(json.dumps({"timing": f"dp_clip {case} float32",
                          "shape": [BATCH, widths[0]] if case == "leaf" else
                          [BATCH, sum(widths)], "leaves": len(mats),
                          # threads that share a column group in K2, per leaf
                          "k2_split": [dp.scaled_sum_split(BATCH, w, 4, sms) for w in widths],
                          **{k: {kk: vv for kk, vv in r.items()}
                             for k, r in res[case].items()}}))
        del tree, mats
    torch.cuda.empty_cache()
    return res


def dp_stacks(shapes: dict, c: int, b: int, dtype: torch.dtype, seed: int,
              layout: str, scale: float = 1.0) -> dict:
    """Normal per-example gradients (std ``scale``) of ``c`` clients,
    ``[c, b, *shape]`` on the card, in either layout the client vmap may hand the rules:
    ``clients`` (each client's rows together) or ``rows`` (row-major over
    ``[b, c]``: client stride one leaf, row stride ``c`` leaves)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    lead = (c, b) if layout == "clients" else (b, c)
    out = {}
    for k, s in shapes.items():
        x = (torch.randn((*lead, *s), generator=g, device="cuda") * scale).to(dtype)
        out[k] = x if layout == "clients" else x.transpose(0, 1)
    return out


def dp_batched_checks(dp, dtype: torch.dtype) -> dict:
    """K1's and K2's client-batched entries (``[C, B, W]`` stacks, as the
    vmap rules hand them over) against their plain versions over the
    CifarNet tree of the DP path's 64 clients x 32 examples, in both
    layouts; then the fused clip under ``torch.func.vmap`` over the clients
    (the rules) against the plain clip client by client, with one K1 launch,
    one K2 launch a leaf and no copy of the per-example tensor. Returns the
    max abs error of each kernel."""
    tag = str(dtype).split(".")[-1]
    c, b = DP_CLIENTS, BATCH
    stats, worst = {}, {"dp_sq_norms": 0.0, "dp_scaled_sum": 0.0}
    for layout in ("clients", "rows"):
        tree = dp_stacks(CIFAR_LEAVES, c, b, dtype, 51, layout)
        mats = [v.reshape(c, b, -1) for v in tree.values()]
        if layout == "rows" and mats[0].stride(0) == b * mats[0].stride(1):
            fail("the rows layout must not fold as a view")
        scale = torch.rand((c, b), device="cuda") * 1.5
        scale[:, 1] = 0.0  # a padding example in every client
        with torch.no_grad():
            got = dp.sq_norms_tree_kernel(mats)
            name = f"dp_sq_norms batched {layout} {tag}"
            stats[name] = check_stats(name, got, dp.per_example_tree_sq_norms_reference(mats),
                                      *DP_TOL["dp_sq_norms"])
            if not torch.equal(got, dp.sq_norms_tree_kernel(mats)):
                fail(f"{name}: a second launch differs")
            worst["dp_sq_norms"] = max(worst["dp_sq_norms"], stats[name]["max_abs_err"])
            for k, m in zip(tree, mats):
                name = f"dp_scaled_sum batched {layout} {k} {tag}"
                got = dp.scaled_sum_kernel(m, scale)
                # held against the plain version's sum evaluated in f64: at
                # sums of up to ~27 (32 products, scale up to 1.5) the bound
                # is 5 f32 ulps, which the kernel's rounding and the f32
                # plain version's, in two orders, can exceed together
                exact = (m.double() * scale.double()[..., None]).sum(-2)
                stats[name] = check_stats(name, got, exact, *DP_TOL["dp_scaled_sum"])
                stats[name]["f32_plain_max_abs_err"] = float(
                    (got - dp.scaled_masked_sum_reference(m, scale)).abs().max())
                del exact
                if not torch.equal(got, dp.scaled_sum_kernel(m, scale)):
                    fail(f"{name}: a second launch differs")
                worst["dp_scaled_sum"] = max(worst["dp_scaled_sum"],
                                             stats[name]["max_abs_err"])
        del tree, mats
    # the rules: the fused clip vmapped over the clients, on gradient-sized
    # values that C = 1 clips in part, in the layout that does not fold
    grads = dp_stacks(CIFAR_LEAVES, c, b, dtype, 52, "rows", scale=1e-3)
    mask = torch.ones((c, b), device="cuda")
    mask[:, 1] = 0.0
    dp.reset_launch_counts()
    with torch.no_grad():
        got, norms = torch.func.vmap(
            lambda t, m: dp.fused_clipped_masked_sum(t, m, DP_CLIP, return_norms=True),
            randomness="error")(grads, mask)
        torch.cuda.synchronize()
        launches, copies = dict(dp.LAUNCHES), dict(dp.COPIES)
        for i in range(c):
            want, want_norms = fused_plain(dp, {k: v[i] for k, v in grads.items()}, mask[i],
                                           DP_CLIP)
            stats[f"vmapped fused norms {tag} client {i}"] = check_stats(
                f"vmapped fused norms {tag}", norms[i], want_norms, *DP_TOL["dp_sq_norms"])
            for k in want:
                stats[f"vmapped fused {k} {tag} client {i}"] = check_stats(
                    f"vmapped fused {k} {tag}", got[k][i], want[k], *DP_TOL["fused"])
    want_launches = {"dp_sq_norms": 1, "dp_scaled_sum": len(CIFAR_LEAVES)}
    print(json.dumps({"check": f"dp_clip client-batched {tag}", "clients": c, "batch": b,
                      "max_abs_err": worst,
                      "scaled_sum_vs_f32_plain_max_abs_err": max(
                          v.get("f32_plain_max_abs_err", 0.0) for v in stats.values()),
                      "vmapped_fused_max_abs_err": max(
                          v["max_abs_err"] for k, v in stats.items() if "vmapped" in k),
                      "bound_used": max(v["bound_used"] for v in stats.values()),
                      "vmapped_launches": launches, "vmapped_copies": copies,
                      "tolerance": {k: list(v) for k, v in DP_TOL.items()}}))
    if launches != want_launches or any(copies.values()):
        fail(f"the vmapped fused clip launched {launches} (expected {want_launches}) "
             f"and copied {copies}")
    del grads, got
    torch.cuda.empty_cache()
    return worst


def dp_batched_timings(dp) -> dict:
    """K1 and K2 at the DP path's client-batched shapes, f32: the largest
    leaf [64, 32, 524288] and the whole CifarNet tree of 64 clients (K1 one
    call over the tree, K2 one call a leaf, as the path makes them), beside
    their plain versions and a library call computing the same function
    (``torch.bmm(scale[:, None, :], g)`` for K2; ``vector_norm`` per leaf,
    stacked, squared and summed for K1), a yardstick the port never calls.
    Bounds: bytes in and out once over 3.35 TB/s, against two f32
    operations per element over the f32 rate."""
    c, b = DP_CLIENTS, BATCH
    res = {}
    time_it = lambda fn: cuda_ms(fn, calls=20)  # noqa: E731
    for case, shapes in (("leaf", {"Dense_0/kernel": (524288,)}), ("tree", CIFAR_LEAVES)):
        tree = dp_stacks(shapes, c, b, torch.float32, 53, "clients")
        mats = [v.reshape(c, b, -1) for v in tree.values()]
        scale = torch.rand((c, b), device="cuda")
        widths = [m.shape[2] for m in mats]
        elems = c * b * sum(widths)
        with torch.no_grad():
            res[case] = {
                "dp_sq_norms": dict(
                    ms=time_it(lambda: dp.sq_norms_tree_kernel(mats)),
                    plain_ms=time_it(lambda: dp.per_example_tree_sq_norms_reference(mats)),
                    library_ms=time_it(lambda: torch.stack([torch.linalg.vector_norm(
                        m, dim=2) for m in mats]).square().sum(0)),
                    bound=bound_ms(2 * elems, 4 * elems + 4 * c * b, torch.float32)),
                "dp_scaled_sum": dict(
                    ms=time_it(lambda: [dp.scaled_sum_kernel(m, scale) for m in mats]),
                    plain_ms=time_it(lambda: [dp.scaled_masked_sum_reference(m, scale)
                                              for m in mats]),
                    library_ms=time_it(lambda: [torch.bmm(scale[:, None, :], m)
                                                for m in mats]),
                    bound=bound_ms(2 * elems, 4 * elems + 4 * c * b * len(mats)
                                   + 4 * c * sum(widths), torch.float32)),
            }
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        print(json.dumps({"timing": f"dp_clip client-batched {case} float32",
                          "shape": [c, b, widths[0] if case == "leaf" else sum(widths)],
                          "leaves": len(mats),
                          "k2_split": [dp.scaled_sum_split(b, w, 4, sms, c) for w in widths],
                          **res[case]}))
        del tree, mats
    torch.cuda.empty_cache()
    return res


def telemetry_build():
    """An observability handle that switches on the telemetry build alone
    (a private registry and tracer; no fence, recorder, ledger or output):
    DP's clip fraction then rides the fit losses, as in JAX."""
    from fl4health_tpu_torch.observability import MetricsRegistry, Observability, Tracer

    return Observability(enabled=True, registry=MetricsRegistry(), tracer=Tracer(),
                         sync_device=False, flight_recorder=False, fleet_ledger=False,
                         introspection=False)


def build_dp_sim(data, dtype, device, noise_multiplier, seed,
                 input_shape=(32, 32, 3), batch=BATCH, local_steps=LOCAL_STEPS, strategy=None,
                 logic=None, **sim_kw):
    from fl4health_tpu_torch import optim
    from fl4health_tpu_torch.clients import engine
    from fl4health_tpu_torch.clients.instance_level_dp import InstanceLevelDpClientLogic
    from fl4health_tpu_torch.metrics import efficient
    from fl4health_tpu_torch.metrics.base import MetricManager
    from fl4health_tpu_torch.models.cnn import CifarNet
    from fl4health_tpu_torch.server.simulation import FederatedSimulation
    from fl4health_tpu_torch.strategies.fedavg import FedAvg

    logic = logic or InstanceLevelDpClientLogic(
        engine.from_module(CifarNet(dtype=dtype, input_shape=input_shape)),
        engine.masked_cross_entropy, clipping_bound=DP_CLIP,
        noise_multiplier=noise_multiplier)
    return FederatedSimulation(
        logic=logic, tx=optim.sgd(0.05), strategy=strategy or FedAvg(), datasets=data,
        batch_size=batch, metrics=MetricManager((efficient.accuracy(),)),
        local_steps=local_steps, seed=seed, device=device, **sim_kw)


def image_datasets(n_clients: int, n_train: int, n_val: int, shape,
                   n_test: int = 0) -> list:
    """Client i's rows from ``PRNGKey(i)``, drawn on the card; its test rows,
    if any, from ``PRNGKey(10_000 + i)``."""
    from fl4health_tpu_torch import rng
    from fl4health_tpu_torch.datasets.synthetic import synthetic_classification
    from fl4health_tpu_torch.server.simulation import ClientDataset

    out = []
    for i in range(n_clients):
        x, y = (a.cpu() for a in synthetic_classification(
            rng.PRNGKey(i, "cuda"), n_train + n_val, shape, 10))
        test = {}
        if n_test:
            xt, yt = (a.cpu() for a in synthetic_classification(
                rng.PRNGKey(10_000 + i, "cuda"), n_test, shape, 10))
            test = dict(x_test=xt, y_test=yt)
        out.append(ClientDataset(x[:n_train], y[:n_train], x[n_train:], y[n_train:],
                                 **test))
    return out


def tiny_dp_parity(dp) -> None:
    """The same tiny DP run (f32, noise 0) on the card through the kernels
    and on the CPU through the plain versions, from the same params."""
    data = image_datasets(2, 16, 8, (32, 32, 3))
    runs = []
    for device in ("cuda", "cpu"):
        sim = build_dp_sim(data, torch.float32, device, 0.0, seed=3, batch=8,
                           local_steps=2, observability=telemetry_build())
        if runs:
            sim.set_global_params({k: v.cpu() for k, v in runs[0][2].items()})
        init = {k: v.clone() for k, v in sim.global_params.items()}
        dp.reset_launch_counts()
        runs.append((sim.fit(2), sim.global_params, init, dict(dp.LAUNCHES)))
    (gpu_hist, gpu_params, _, gpu_launches), (cpu_hist, cpu_params, _, cpu_launches) = runs
    if min(gpu_launches.values()) == 0 or max(cpu_launches.values()) != 0:
        fail(f"tiny DP run: launches {gpu_launches} on the card, {cpu_launches} on the CPU")
    for gr, cr in zip(gpu_hist, cpu_hist):
        check(f"tiny DP fit loss r{gr.round}", torch.tensor(gr.fit_losses["backward"]),
              torch.tensor(cr.fit_losses["backward"]), 5e-4, 0)
        check(f"tiny DP eval loss r{gr.round}",
              torch.tensor(gr.eval_losses["checkpoint"]),
              torch.tensor(cr.eval_losses["checkpoint"]), 5e-4, 0)
    err = max(check(f"tiny DP param {k}", gpu_params[k].cpu(), cpu_params[k], 5e-4, 0)
              for k in cpu_params)
    print(json.dumps({"tiny_dp_parity": "cuda kernels vs cpu plain", "rounds": 2,
                      "noise_multiplier": 0.0,
                      "fit_losses": [r.fit_losses["backward"] for r in gpu_hist],
                      "clip_fraction": [r.fit_losses["clip_fraction"] for r in gpu_hist],
                      "launches": gpu_launches, "max_param_abs_err": err}))


def dp_main_path(dp) -> dict:
    """Full-width DP-FedAvg of CifarNet, bf16 compute, 2 rounds."""
    from fl4health_tpu_torch.server.servers import InstanceLevelDpServer

    data = image_datasets(DP_CLIENTS, DP_TRAIN, DP_VAL, (32, 32, 3))
    # the telemetry build, for the clip fraction (no fence, no recorder)
    sim = build_dp_sim(data, torch.bfloat16, "cuda", DP_SIGMA, seed=0,
                       observability=telemetry_build())
    server = InstanceLevelDpServer(sim, noise_multiplier=DP_SIGMA, batch_size=BATCH)
    init = {k: v.clone() for k, v in sim.global_params.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dp.reset_launch_counts()
    t0 = time.time()
    hist, epsilon = server.fit(DP_ROUNDS)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches, copies = dict(dp.LAUNCHES), dict(dp.COPIES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    examples = DP_CLIENTS * LOCAL_STEPS * BATCH
    for r in hist:
        if not all(np.isfinite(v) for v in (*r.fit_losses.values(),
                                              *r.eval_losses.values())):
            fail(f"DP round {r.round}: non-finite losses {r.fit_losses} {r.eval_losses}")
        print(json.dumps({
            "dp_round": r.round, "fit_loss": r.fit_losses["backward"],
            "clip_fraction": r.fit_losses["clip_fraction"],
            "eval_loss": r.eval_losses["checkpoint"],
            "eval_accuracy": r.eval_metrics["accuracy"],
            "fit_dispatch_s": r.fit_elapsed_s, "eval_dispatch_s": r.eval_elapsed_s}))
    moved = max(float((sim.global_params[k] - init[k]).abs().max()) for k in init)
    finite = all(torch.isfinite(v).all() for v in sim.global_params.values())
    if not finite or moved <= 0:
        fail(f"DP global params after training: finite={finite}, max change {moved}")
    # per round: 5 steps of all 64 clients, each one K1 launch over the tree
    # and one K2 launch per leaf, through the vmap rules
    steps = DP_ROUNDS * LOCAL_STEPS
    expected = {"dp_sq_norms": steps, "dp_scaled_sum": steps * len(CIFAR_LEAVES)}
    walls = pipeline_walls(sim)
    # 64 clients: the aggregate's windowed sum, and the one reduction it
    # replaced swapped in, in turns
    agg_walls = aggregate_walls(sim)
    print(json.dumps({"main_path": "dp_fedavg_cifar_cnn", "rounds": DP_ROUNDS,
                      "wall_s": wall, "warm_walls": walls, "aggregate_walls": agg_walls,
                      # per second of synchronised round wall (fit and eval)
                      "train_examples_per_s": [WARM_ROUNDS * examples / w
                                               for w in walls["pipelined_s"]],
                      "epsilon": epsilon,
                      "n_params": sum(v.numel() for v in init.values()),
                      "peak_mem_gib": peak,
                      "max_param_change": moved, "launches": launches,
                      "expected_launches": expected, "per_example_copies": copies}))
    if abs(epsilon - DP_EPSILON) > 1e-9:
        fail(f"DP epsilon {epsilon!r}, the accountant gives {DP_EPSILON!r}")
    if launches != expected:
        fail(f"DP main-path launches {launches}, expected {expected}")
    if any(copies.values()):
        fail(f"the DP path copied per-example gradients: {copies}")
    return launches


def rng_card_check() -> None:
    """The random stream drawn on the card against the same draws on the CPU."""
    from fl4health_tpu_torch import rng

    def same(name, got, want):
        if got.device.type != "cuda":
            fail(f"rng {name}: drawn on {got.device}, not on the card")
        if not torch.equal(got.cpu(), want):
            fail(f"rng {name}: the card's draws differ from the CPU's")

    exact, n_normal, normal_err = 0, 0, 0.0
    for seed in (0, 7, 2**31 - 1):
        kg, kc = rng.PRNGKey(seed, "cuda"), rng.PRNGKey(seed)
        for n in (2, 3, 8):
            same(f"split {seed} {n}", rng.split(kg, n), rng.split(kc, n))
        for d in (0, 2001, 2**32 - 1):
            same(f"fold_in {seed} {d}", rng.fold_in(kg, d), rng.fold_in(kc, d))
        for shape in RNG_SHAPES:
            same(f"bits {seed} {shape}", rng.bits(kg, shape), rng.bits(kc, shape))
            same(f"uniform {seed} {shape}", rng.uniform(kg, shape), rng.uniform(kc, shape))
            same(f"uniform(-2.5, 3) {seed} {shape}", rng.uniform(kg, shape, -2.5, 3.0),
                 rng.uniform(kc, shape, -2.5, 3.0))
        for n in (64, 1000):
            same(f"permutation {seed} {n}", rng.permutation(kg, n), rng.permutation(kc, n))
        for shape, lo, hi in (((64,), 0, 10), ((3, 5, 11), -2**31, 2**31 - 1)):
            same(f"randint {seed} {shape}", rng.randint(kg, shape, lo, hi),
                 rng.randint(kc, shape, lo, hi))
        logits = torch.linspace(-3.0, 3.0, 63)
        same(f"categorical {seed}", rng.categorical(kg, logits.cuda(), (80, 40)),
             rng.categorical(kc, logits, (80, 40)))
        got, want = rng.normal(kg, RNG_SHAPES[-1]), rng.normal(kc, RNG_SHAPES[-1])
        normal_err = max(normal_err, check(f"rng normal {seed}", got.cpu(), want, 1e-6, 1e-6))
        exact += int((got.cpu() == want).sum())
        n_normal += want.numel()

    # the server's noise of one CifarNet round, as the strategy draws it: one
    # key per leaf, one normal draw per leaf
    key = rng.PRNGKey(0, "cuda")

    def server_noise():
        return [rng.normal(k, s) for k, s in zip(rng.split(key, len(CIFAR_LEAVES)),
                                                  CIFAR_LEAVES.values())]
    server_noise()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        server_noise()
    torch.cuda.synchronize()
    out = {"check": "rng card vs cpu", "seeds": [0, 7, 2**31 - 1],
           "bit_exact": ["split", "fold_in", "bits", "uniform", "permutation", "randint",
                         "categorical"],
           "normal_max_abs_err": normal_err, "normal_tolerance": [1e-6, 1e-6],
           "normal_bit_exact_share": exact / n_normal,
           # per draw of all 8 leaves' noise (579,402 normals): CUDA events
           # behind the spin kernel (the draw's ~1,900 launches outlast the
           # spin, so this reads the launch rate, not the device) and host wall
           "server_noise_event_ms": cuda_ms(server_noise),
           "server_noise_wall_ms": (time.perf_counter() - t0) / 20 * 1e3}
    print(json.dumps(out))


def hospital_datasets(n_clients: int, pool: int, shape, seed: int = 0) -> list:
    """``pool`` synthetic rows cut into ``n_clients`` uneven clients by the
    client_level_dp_weighted example's size profile, each split 80/20 with
    hash key 7 + i."""
    from fl4health_tpu_torch import rng
    from fl4health_tpu_torch.datasets.synthetic import synthetic_classification
    from fl4health_tpu_torch.datasets.vision import split_data_and_targets
    from fl4health_tpu_torch.server.simulation import ClientDataset

    x, y = (a.cpu().numpy() for a in synthetic_classification(
        rng.PRNGKey(seed, "cuda"), pool, shape, 10))
    profile = np.linspace(64, 256, n_clients)
    sizes = np.floor(profile * pool / profile.sum()).astype(int)
    sizes[: pool - sizes.sum()] += 1  # the flooring remainder
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    return [ClientDataset(*split_data_and_targets(x[offsets[i]:offsets[i + 1]],
                                                  y[offsets[i]:offsets[i + 1]], 0.2, 7 + i))
            for i in range(n_clients)]


def build_client_dp_sim(data, module, device, fraction, seed, batch=BATCH,
                        local_steps=LOCAL_STEPS, lr=CDP_LR, strategy=CDP_STRATEGY):
    from fl4health_tpu_torch import optim
    from fl4health_tpu_torch.clients import engine
    from fl4health_tpu_torch.clients.clipping import ClippingClientLogic
    from fl4health_tpu_torch.metrics import efficient
    from fl4health_tpu_torch.metrics.base import MetricManager
    from fl4health_tpu_torch.server.client_manager import PoissonSamplingManager
    from fl4health_tpu_torch.server.simulation import FederatedSimulation
    from fl4health_tpu_torch.strategies.client_dp_fedavgm import ClientLevelDPFedAvgM

    return FederatedSimulation(
        logic=ClippingClientLogic(engine.from_module(module), engine.masked_cross_entropy,
                                  adaptive_clipping=True),
        tx=optim.sgd(lr), strategy=ClientLevelDPFedAvgM(**strategy), datasets=data,
        batch_size=batch, metrics=MetricManager((efficient.accuracy(),)),
        local_steps=local_steps, client_manager=PoissonSamplingManager(len(data), fraction),
        seed=seed, device=device)


def record_rounds(sim) -> tuple[list, list]:
    """Keep every mask the manager hands out and every clipping bound the
    strategy sets, as tensors (no sync inside the round)."""
    masks, bounds = [], []
    sample, aggregate = sim.client_manager.sample, sim.strategy.aggregate

    def sample_rec(key, round_idx):
        masks.append(sample(key, round_idx))
        return masks[-1]

    def aggregate_rec(*args):
        state = aggregate(*args)
        bounds.append(state.clipping_bound)
        return state

    sim.client_manager.sample, sim.strategy.aggregate = sample_rec, aggregate_rec
    return masks, bounds


def tiny_client_dp_parity() -> None:
    """The same tiny client-level DP run (f32) on the card and on the CPU."""
    from fl4health_tpu_torch.models.cnn import Mlp

    data = hospital_datasets(8, 480, (14, 14, 1))
    runs = []
    for device in ("cuda", "cpu"):
        sim = build_client_dp_sim(data, Mlp(14 * 14, (16,), 10), device, 0.5, seed=11,
                                  batch=16, local_steps=3, lr=0.05,
                                  strategy=TINY_CDP_STRATEGY)
        if runs:
            sim.set_global_params({k: v.cpu() for k, v in runs[0][2].items()})
        init = {k: v.clone() for k, v in sim.global_params.items()}
        masks, bounds = record_rounds(sim)
        runs.append((sim.fit(2), sim.global_params, init, masks, bounds))
    (gh, gp, _, gm, gb), (ch, cp, _, cm, cb) = runs
    for r, (g, c) in enumerate(zip(gm, cm), 1):
        if g.device.type != "cuda" or not torch.equal(g.cpu(), c):
            fail(f"tiny client DP round {r}: masks {g.tolist()} on the card, "
                 f"{c.tolist()} on the CPU")
    for gr, cr in zip(gh, ch):
        check(f"tiny client DP fit loss r{gr.round}", torch.tensor(gr.fit_losses["backward"]),
              torch.tensor(cr.fit_losses["backward"]), 5e-4, 0)
        check(f"tiny client DP eval loss r{gr.round}",
              torch.tensor(gr.eval_losses["checkpoint"]),
              torch.tensor(cr.eval_losses["checkpoint"]), 5e-4, 0)
    for r, (g, c) in enumerate(zip(gb, cb), 1):
        check(f"tiny client DP clipping bound r{r}", g.cpu(), c, 5e-4, 0)
    err = max(check(f"tiny client DP param {k}", gp[k].cpu(), cp[k], 5e-4, 0) for k in cp)
    print(json.dumps({"tiny_client_dp_parity": "cuda vs cpu", "rounds": 2,
                      "masks": [m.tolist() for m in gm],
                      "fit_losses": [r.fit_losses["backward"] for r in gh],
                      "clipping_bounds": [float(b) for b in gb],
                      "max_param_abs_err": err}))


# vmapped against looped clients on the card, f32 with TF32 off: the two
# differ only in the order of the reductions that batched and per-client
# GEMMs and convolutions take, a few f32 ulps a step (the CPU tests hold them
# to 1e-5 too)
VMAP_TOL = 1e-5
# the relative l2 gap between the vmapped and the looped update of one
# full-width f32 round of transformer_long (5 local steps): read at 2.4e-5
# on an H100 (the batched and the per-client GEMMs sum in other orders);
# about 4x that
VMAP_F32_GAP = 1e-4


def vmap_vs_loop(fa, dp) -> dict:
    """The client axis on the card: a tiny run of each path (f32, 2 rounds)
    once through ``vmap_clients`` (the main path) and once through
    ``loop_clients`` (its plain version), from the same params: per-round
    losses and final params within VMAP_TOL. The transformer and DP runs
    launch each kernel once for all their clients under the vmap and once a
    client in the loop; the DP run draws its noise at sigma = 1 from the
    clients' keys in both."""
    from fl4health_tpu_torch.models.cnn import Mlp
    from fl4health_tpu_torch.server import simulation as tsim

    tiny_cfg = dict(vocab_size=64, n_classes=4, d_model=64, n_heads=2, n_layers=2,
                    d_ff=128, max_len=80)
    text, images = text_datasets(64, 80, 48, 40), image_datasets(2, 16, 8, (32, 32, 3))
    hospitals = hospital_datasets(8, 480, (14, 14, 1))
    builds = {
        "transformer": lambda: build_sim(tiny_cfg, text, torch.float32, "cuda", seed=3),
        "dp": lambda: build_dp_sim(images, torch.float32, "cuda", 1.0, seed=3, batch=8,
                                   local_steps=2),
        "client_dp": lambda: build_client_dp_sim(
            hospitals, Mlp(14 * 14, (16,), 10), "cuda", 0.5, seed=11, batch=16,
            local_steps=3, lr=0.05, strategy=TINY_CDP_STRATEGY),
    }
    out = {}
    for name, build in builds.items():
        runs, init = {}, None
        for axis in (tsim.vmap_clients, tsim.loop_clients):
            sim = build()
            sim._fit_round, sim._eval_round = sim._build_round_fns(axis)
            if init is None:
                init = {k: v.clone() for k, v in sim.global_params.items()}
            sim.set_global_params(init)
            fa.reset_launch_counts()
            dp.reset_launch_counts()
            hist = sim.fit(2)
            torch.cuda.synchronize()
            losses = torch.tensor([x for r in hist for x in (*r.fit_losses.values(),
                                                             *r.eval_losses.values())])
            runs[axis.__name__] = (losses, sim.global_params,
                                   {**fa.LAUNCHES, **dp.LAUNCHES})
        (lv, pv, nv), (ll, pl, nl) = runs["vmap_clients"], runs["loop_clients"]
        loss_err = check(f"vmap vs loop {name} losses", lv, ll, VMAP_TOL, 0)
        param_err = max(check(f"vmap vs loop {name} param {k}", pv[k], pl[k], VMAP_TOL, 0)
                        for k in pv)
        n_clients = sim.n_clients
        if any(nl[k] != n_clients * nv[k] for k in nv):
            fail(f"vmap vs loop {name}: launches {nv} vmapped, {nl} looped over "
                 f"{n_clients} clients")
        out[name] = {"loss_max_abs_err": loss_err, "param_max_abs_err": param_err,
                     "launches_vmapped": {k: v for k, v in nv.items() if v},
                     "launches_looped": {k: v for k, v in nl.items() if v}}
    print(json.dumps({"check": "vmapped clients vs the loop on the card", "rounds": 2,
                      "tolerance": VMAP_TOL, **out}))
    out["full_width"] = full_width_vmap_gap()
    return out


def full_width_vmap_gap() -> dict:
    """The client axis at the main path's width and precision: one round of
    transformer_long as the main path runs it (both clients, full width, 5
    local steps: after the first the clients' weights differ) through
    ``vmap_clients`` and through ``loop_clients``, in bf16 compute (the main
    path's) and in f32, from the same params. A pair's gap is the relative
    l2 distance between the two rounds' updates of the global params (all
    leaves as one vector), beside the abs gap of their fit losses. Held: in
    bf16 the vmap moves the update by no more than bf16 compute moves the
    loop's (loop bf16 against loop f32); in f32, by at most VMAP_F32_GAP."""
    from fl4health_tpu_torch.server import simulation as tsim

    cfg = dict(vocab_size=8192, n_classes=4, d_model=512, n_heads=8, n_layers=4,
               d_ff=2048, max_len=T)
    data = text_datasets(8192, T, BATCH * LOCAL_STEPS + 16, BATCH * LOCAL_STEPS)
    runs, init = {}, None
    for dtype in (torch.bfloat16, torch.float32):
        for axis in (tsim.vmap_clients, tsim.loop_clients):
            sim = build_sim(cfg, data, dtype, "cuda", seed=0)
            sim._fit_round, sim._eval_round = sim._build_round_fns(axis)
            if init is None:
                init = {k: v.clone() for k, v in sim.global_params.items()}
            sim.set_global_params(init)
            (rec,) = sim.fit(1)
            update = torch.cat([(sim.global_params[k] - init[k]).flatten() for k in init])
            if not torch.isfinite(update).all():
                fail(f"full-width vmap gap: non-finite update {dtype} {axis.__name__}")
            runs[(str(dtype).split(".")[-1], axis.__name__[:4])] = (
                rec.fit_losses["backward"], update)
            del sim
            torch.cuda.empty_cache()

    def gap(a, b):
        (la, ua), (lb, ub) = runs[a], runs[b]
        return {"update_rel_l2": float((ua - ub).norm() / ub.norm()),
                "fit_loss_abs": abs(la - lb)}
    res = {"vmap_vs_loop_bf16": gap(("bfloat16", "vmap"), ("bfloat16", "loop")),
           "vmap_vs_loop_f32": gap(("float32", "vmap"), ("float32", "loop")),
           "loop_bf16_vs_loop_f32": gap(("bfloat16", "loop"), ("float32", "loop")),
           "fit_losses": {"_".join(k): v[0] for k, v in runs.items()},
           "update_norms": {"_".join(k): float(v[1].norm()) for k, v in runs.items()},
           "f32_limit": VMAP_F32_GAP}
    print(json.dumps({"check": "vmapped clients vs the loop, one full-width round", **res}))
    if res["vmap_vs_loop_bf16"]["update_rel_l2"] > res["loop_bf16_vs_loop_f32"]["update_rel_l2"]:
        fail(f"full-width vmap gap: the vmap moves the bf16 update by more than bf16 "
             f"compute does: {res}")
    if res["vmap_vs_loop_f32"]["update_rel_l2"] > VMAP_F32_GAP:
        fail(f"full-width vmap gap: f32 vmapped and looped updates differ by "
             f"{res['vmap_vs_loop_f32']['update_rel_l2']}, limit {VMAP_F32_GAP}")
    return res


def client_dp_main_path(fa, dp) -> None:
    """Full-width client-level DP-FedAvgM of CifarNet, bf16 compute, 2 rounds."""
    from fl4health_tpu_torch.models.cnn import CifarNet
    from fl4health_tpu_torch.server.servers import ClientLevelDpFedAvgServer

    data = hospital_datasets(CDP_CLIENTS, CDP_POOL, (32, 32, 3))
    sim = build_client_dp_sim(data, CifarNet(10, dtype=torch.bfloat16), "cuda",
                              CDP_FRACTION, seed=0)
    server = ClientLevelDpFedAvgServer(sim, noise_multiplier=CDP_STRATEGY["noise_multiplier"])
    masks, bounds = record_rounds(sim)
    init = {k: v.clone() for k, v in sim.global_params.items()}
    counters = lambda: [dict(c) for c in (fa.LAUNCHES, fa.WGMMA_LAUNCHES, dp.LAUNCHES)]  # noqa: E731
    before = counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    hist, epsilon = server.fit(CDP_ROUNDS)
    torch.cuda.synchronize()
    wall = time.time() - t0
    after = counters()
    peak = torch.cuda.max_memory_allocated() / 2**30
    for r, mask, bound in zip(hist, masks, bounds):
        values = (*r.fit_losses.values(), *r.eval_losses.values())
        if not all(np.isfinite(v) for v in values):
            fail(f"client DP round {r.round}: non-finite losses {r.fit_losses} "
                 f"{r.eval_losses}")
        print(json.dumps({
            "client_dp_round": r.round, "fit_loss": r.fit_losses["backward"],
            "eval_loss": r.eval_losses["checkpoint"],
            "eval_accuracy": r.eval_metrics["accuracy"], "clipping_bound": float(bound),
            "clients_sampled": int(mask.sum()), "fit_dispatch_s": r.fit_elapsed_s,
            "eval_dispatch_s": r.eval_elapsed_s}))
    moved = max(float((sim.global_params[k] - init[k]).abs().max()) for k in init)
    finite = all(torch.isfinite(v).all() for v in sim.global_params.values())
    walls = pipeline_walls(sim)
    print(json.dumps({"main_path": "client_dp_cifar_cnn", "rounds": CDP_ROUNDS,
                      "wall_s": wall, "warm_walls": walls, "epsilon": epsilon,
                      "n_params": sum(v.numel() for v in init.values()),
                      "clients": CDP_CLIENTS,
                      "train_rows": [min(d.n_train for d in data),
                                     max(d.n_train for d in data)],
                      "peak_mem_gib": peak,
                      "max_param_change": moved, "launch_counters_moved": before != after}))
    if not finite or moved <= 0:
        fail(f"client DP global params after training: finite={finite}, max change {moved}")
    if abs(epsilon - CDP_EPSILON) > 1e-9:
        fail(f"client DP epsilon {epsilon!r}, the accountant gives {CDP_EPSILON!r}")
    if before != after:
        fail(f"the client-level DP path launched kernels: {before} -> {after}")


def pipelined_dp_path(dp) -> dict:
    """The DP path with every feature of the pipelined round: a test split,
    early stopping, a strict failure policy, a JSON report; 3 rounds
    pipelined, then the same 3 rounds through the plain version from the
    same state, which must agree bit for bit."""
    import tempfile

    from fl4health_tpu_torch.clients.engine import EarlyStoppingConfig
    from fl4health_tpu_torch.reporting.base import JsonReporter
    from fl4health_tpu_torch.server.simulation import FailurePolicy

    data = image_datasets(DP_CLIENTS, DP_TRAIN, DP_VAL, (32, 32, 3), n_test=PIPE_TEST)

    def build(**kw):
        return build_dp_sim(data, torch.bfloat16, "cuda", DP_SIGMA, seed=0,
                            early_stopping=EarlyStoppingConfig(PIPE_INTERVAL, PIPE_PATIENCE),
                            failure_policy=FailurePolicy(accept_failures=False),
                            pipeline_depth=2, **kw)

    # both runs take the same cuDNN algorithms, so the plain version can
    # repeat the pipelined run bit for bit
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with tempfile.TemporaryDirectory() as out_dir:
            sim = build(reporters=[JsonReporter(out_dir, run_id="pipelined")])
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            dp.reset_launch_counts()
            t0 = time.time()
            hist = sim.fit(PIPE_ROUNDS)
            torch.cuda.synchronize()
            wall = time.time() - t0
            launches = dict(dp.LAUNCHES)
            peak = torch.cuda.max_memory_allocated() / 2**30
            report = json.loads((Path(out_dir) / "pipelined.json").read_text())
        inline = build()
        torch.cuda.synchronize()
        t0 = time.time()
        inline_rounds(inline, PIPE_ROUNDS)
        torch.cuda.synchronize()
        inline_wall = time.time() - t0
    finally:
        torch.backends.cudnn.deterministic = deterministic
    fields = ("fit_losses", "fit_metrics", "eval_losses", "eval_metrics")
    for r in hist:
        values = [v for f in fields for v in getattr(r, f).values()]
        if not all(np.isfinite(v) for v in values):
            fail(f"pipelined round {r.round}: non-finite values {r}")
        if "test - checkpoint" not in r.eval_losses or "test - accuracy" not in r.eval_metrics:
            fail(f"pipelined round {r.round}: no test-split keys {r.eval_losses} "
                 f"{r.eval_metrics}")
        print(json.dumps({"pipelined_round": r.round, "fit_loss": r.fit_losses["backward"],
                          "eval_loss": r.eval_losses["checkpoint"],
                          "test_loss": r.eval_losses["test - checkpoint"],
                          "test_accuracy": r.eval_metrics["test - accuracy"],
                          "fit_dispatch_s": r.fit_elapsed_s,
                          "eval_dispatch_s": r.eval_elapsed_s}))
    reported = {r: {f: v[f] for f in fields} for r, v in report["rounds"].items()}
    if reported != {str(r.round): {f: getattr(r, f) for f in fields} for r in hist}:
        fail(f"the JSON report's rounds differ from the history: {reported}")
    inline_equal = (
        all(getattr(a, f) == getattr(b, f) for a, b in zip(hist, inline.history)
            for f in fields)
        and [r.round for r in hist] == [r.round for r in inline.history]
        and all(torch.equal(sim.global_params[k], v) for k, v in inline.global_params.items())
        and torch.equal(sim.client_states.step, inline.client_states.step))
    # every chunk's steps launch, stopped or not: 3 chunks of 2 a round
    n_chunks = -(-LOCAL_STEPS // PIPE_INTERVAL)
    steps = PIPE_ROUNDS * n_chunks * PIPE_INTERVAL
    expected = {"dp_sq_norms": steps, "dp_scaled_sum": steps * len(CIFAR_LEAVES)}
    moved_steps = sim.client_states.step.cpu()
    res = {"phase": "pipelined_dp_cifar_cnn", "rounds": PIPE_ROUNDS, "wall_s": wall,
           "dispatch_s": sum(r.fit_elapsed_s + r.eval_elapsed_s for r in hist),
           "inline_wall_s": inline_wall, "peak_mem_gib": peak,
           "launches": launches, "expected_launches": expected,
           "steps_moved": int(moved_steps.sum()),
           "steps_scheduled": PIPE_ROUNDS * LOCAL_STEPS * DP_CLIENTS,
           "clients_stopped_early": int((moved_steps < PIPE_ROUNDS * LOCAL_STEPS).sum()),
           "report_rounds": sorted(report["rounds"]), "inline_bit_equal": inline_equal}
    print(json.dumps(res))
    if launches != expected:
        fail(f"pipelined phase launches {launches}, expected {expected}")
    if not inline_equal:
        fail("the pipelined history differs from the inline path's")
    res["nan_client"] = nan_client_check()
    return res


def nan_client_check() -> dict:
    """A tiny DP run (f32, sigma 0) on the card with the last of 4 clients'
    train features NaN: under accept_failures=False, fit raises
    ClientFailuresError naming that client and round 1; under True it
    finishes, screening the client out every round, within VMAP_TOL of the
    run of the other 3 (the same keys and index plans: the poisoned client
    is the last)."""
    import dataclasses

    from fl4health_tpu_torch.server.simulation import ClientFailuresError, FailurePolicy

    clean = image_datasets(4, 16, 8, (32, 32, 3))
    poisoned = [*clean[:3], dataclasses.replace(
        clean[3], x_train=torch.full_like(clean[3].x_train, float("nan")))]

    def build(data, accept):
        return build_dp_sim(data, torch.float32, "cuda", 0.0, seed=3, batch=8, local_steps=2,
                            failure_policy=FailurePolicy(accept_failures=accept))

    strict = build(poisoned, False)
    raised = None
    try:
        strict.fit(2)
    except ClientFailuresError as err:
        raised = err
    if raised is None:
        fail("a NaN-poisoned client did not raise under accept_failures=False")
    if raised.clients != [3] or raised.round != 1 or strict.history:
        fail(f"ClientFailuresError named clients {raised.clients}, round {raised.round} "
             f"({len(strict.history)} rounds recorded); expected [3], round 1, none")
    lenient, alone = build(poisoned, True), build(clean[:3], True)
    screened = []
    screen = lenient.failure_policy.check
    lenient.failure_policy.check = lambda *a: screened.append(screen(*a)) or screened[-1]
    hist, alone_hist = lenient.fit(2), alone.fit(2)
    torch.cuda.synchronize()
    if screened != [[3], [3]]:
        fail(f"the lenient run screened {screened}, expected client 3 in both rounds")
    for a, b in zip(hist, alone_hist):
        check(f"NaN client excluded, round {a.round} fit loss",
              torch.tensor(a.fit_losses["backward"]),
              torch.tensor(b.fit_losses["backward"]), VMAP_TOL, 0)
    err = max(check(f"NaN client excluded, param {k}", v, alone.global_params[k], VMAP_TOL, 0)
              for k, v in lenient.global_params.items())
    res = {"raised": type(raised).__name__, "clients": raised.clients,
           "round": raised.round, "screened": screened,
           "fit_losses": [r.fit_losses["backward"] for r in hist],
           "max_param_abs_err_vs_without_client": err}
    print(json.dumps({"check": "NaN-poisoned client on the card", **res}))
    return res


def dirichlet_cifar_datasets() -> list:
    """Config 2's 16 non-IID clients: the pool from ``PRNGKey(0)``, drawn on
    the card, partitioned on the host. At beta 0.5 over 16 clients the
    Dirichlet draws need more than the default 5 retries to give every
    client each label, so they retry until they do."""
    from fl4health_tpu_torch import rng
    from fl4health_tpu_torch.datasets.partitioners import DirichletLabelBasedAllocation
    from fl4health_tpu_torch.datasets.synthetic import synthetic_classification
    from fl4health_tpu_torch.datasets.vision import split_data_and_targets
    from fl4health_tpu_torch.server.simulation import ClientDataset

    x, y = (a.cpu().numpy() for a in synthetic_classification(
        rng.PRNGKey(0, "cuda"), ALG_POOL, (32, 32, 3), 10))
    partitioner = DirichletLabelBasedAllocation(ALG_CLIENTS, list(range(10)),
                                                min_label_examples=1, beta=ALG_BETA,
                                                hash_key=42)
    parts = partitioner.partition_dataset(x, y, max_retries=None)[0]
    return [ClientDataset(*split_data_and_targets(px, py, 0.2, 7 + i))
            for i, (px, py) in enumerate(parts)]


def build_alg_sim(kind, data, device, dtype=torch.bfloat16, input_shape=(32, 32, 3),
                  batch=BATCH, seed=0, module=None, **sim_kw):
    """A config-2 simulation: ``kind`` "scaffold", "fedprox", "moon" (a
    ``MoonModel`` over dense blocks, FedAvg) or "dp_scaffold" (the DP
    path's settings); one local epoch unless ``local_steps`` is given.
    ``FailurePolicy(accept_failures=False)``: a client whose training loss
    turns non-finite ends the run, where the default would drop it from
    the round's aggregate and go on."""
    from fl4health_tpu_torch import optim
    from fl4health_tpu_torch.clients import engine
    from fl4health_tpu_torch.clients.fedprox import FedProxClientLogic
    from fl4health_tpu_torch.clients.instance_level_dp import DpScaffoldClientLogic
    from fl4health_tpu_torch.clients.moon import MoonClientLogic
    from fl4health_tpu_torch.clients.scaffold import ScaffoldClientLogic
    from fl4health_tpu_torch.metrics import efficient
    from fl4health_tpu_torch.metrics.base import MetricManager
    from fl4health_tpu_torch.models.cnn import CifarNet
    from fl4health_tpu_torch.server.simulation import FailurePolicy, FederatedSimulation
    from fl4health_tpu_torch.strategies.fedavg import FedAvg
    from fl4health_tpu_torch.strategies.fedprox import FedAvgWithAdaptiveConstraint
    from fl4health_tpu_torch.strategies.scaffold import Scaffold

    model = engine.from_module(module or CifarNet(10, dtype=dtype, input_shape=input_shape))
    ce = engine.masked_cross_entropy
    lr = DPS_LR if kind == "dp_scaffold" else ALG_LR
    logic, strategy = {
        "scaffold": lambda: (ScaffoldClientLogic(model, ce, learning_rate=lr), Scaffold(1.0)),
        "fedprox": lambda: (FedProxClientLogic(model, ce),
                            FedAvgWithAdaptiveConstraint(**PROX_STRATEGY)),
        "moon": lambda: (MoonClientLogic(model, ce, contrastive_weight=1.0, buffer_len=2),
                         FedAvg()),
        "dp_scaffold": lambda: (DpScaffoldClientLogic(model, ce, learning_rate=lr,
                                                      clipping_bound=DP_CLIP,
                                                      noise_multiplier=DP_SIGMA),
                                Scaffold(1.0)),
    }[kind]()
    if "local_steps" not in sim_kw:
        sim_kw["local_epochs"] = 1
    sim_kw.setdefault("failure_policy", FailurePolicy(accept_failures=False))
    return FederatedSimulation(
        logic=logic, tx=optim.sgd(lr), strategy=strategy, datasets=data, batch_size=batch,
        metrics=MetricManager((efficient.accuracy(),)), seed=seed, device=device, **sim_kw)


@contextlib.contextmanager
def recorded_states(sim, *fields):
    """Within the block, every server state the strategy's ``aggregate``
    returns, as the named fields' tensors (kept on the device: no sync
    inside the round); the strategy's own ``aggregate`` again after it."""
    states = []
    aggregate = sim.strategy.aggregate

    def aggregate_rec(*args):
        state = aggregate(*args)
        states.append({f: getattr(state, f) for f in fields})
        return state

    sim.strategy.aggregate = aggregate_rec
    try:
        yield states
    finally:
        del sim.strategy.aggregate


def tiny_algorithm_parity(dp) -> dict:
    """The same tiny run of each algorithm (f32, 2 rounds) on the card and on
    the CPU from the same params: SCAFFOLD with its warm start, FedProx,
    MOON (buffer 2) and DP-SCAFFOLD at sigma 1 with its warm start (the
    noise from the clients' keys on both, the kernels on the card); losses
    and params within 5e-4."""
    from fl4health_tpu_torch.models.bases import DenseFeatures, DenseHead, MoonModel
    from fl4health_tpu_torch.server.servers import (DpScaffoldServer, FedProxServer,
                                                    ScaffoldServer)

    images = image_datasets(3, 19, 8, (8, 8, 3))
    out = {}
    for kind in ("scaffold", "fedprox", "moon", "dp_scaffold"):
        runs = []
        for device in ("cuda", "cpu"):
            module = (MoonModel(DenseFeatures(8 * 8 * 3, (16,)), DenseHead(16, 10))
                      if kind == "moon" else None)
            sim = build_alg_sim(kind, images, device, torch.float32, (8, 8, 3), batch=8,
                                seed=3, module=module)
            if runs:
                sim.set_global_params({k: v.cpu() for k, v in runs[0][2].items()})
            init = {k: v.clone() for k, v in sim.global_params.items()}
            server = {"scaffold": lambda: ScaffoldServer(sim, warm_start=True),
                      "fedprox": lambda: FedProxServer(sim),
                      "moon": lambda: sim,
                      "dp_scaffold": lambda: DpScaffoldServer(sim, DP_SIGMA, 8,
                                                              warm_start=True)}[kind]()
            dp.reset_launch_counts()
            hist = server.fit(2)
            if kind == "dp_scaffold":
                hist = hist[0]
            runs.append((hist, sim.global_params, init, dict(dp.LAUNCHES)))
        (gh, gp, _, gl), (ch, cp, _, cl) = runs
        if kind == "dp_scaffold" and (min(gl.values()) == 0 or max(cl.values()) != 0):
            fail(f"tiny dp_scaffold run: launches {gl} on the card, {cl} on the CPU")
        for gr, cr in zip(gh, ch):
            for key in cr.fit_losses:
                check(f"tiny {kind} fit {key} r{gr.round}", torch.tensor(gr.fit_losses[key]),
                      torch.tensor(cr.fit_losses[key]), 5e-4, 0)
            check(f"tiny {kind} eval loss r{gr.round}",
                  torch.tensor(gr.eval_losses["checkpoint"]),
                  torch.tensor(cr.eval_losses["checkpoint"]), 5e-4, 0)
        err = max(check(f"tiny {kind} param {k}", gp[k].cpu(), cp[k], 5e-4, 0) for k in cp)
        out[kind] = {"fit_losses": [r.fit_losses for r in gh], "max_param_abs_err": err,
                     **({"launches": gl} if kind == "dp_scaffold" else {})}
    contrastive = [r["contrastive"] for r in out["moon"]["fit_losses"]]
    if not (contrastive[0] == 0.0 and contrastive[1] > 0):
        fail(f"tiny moon run: the contrastive term {contrastive} is not 0 in round 1 and "
             "positive in round 2")
    print(json.dumps({"tiny_algorithm_parity": "cuda vs cpu", "rounds": 2, **out}))
    return out


def alg_main_path(kind: str, fa, dp, data: list) -> dict:
    """Config 2 at full width on the card, ``kind`` "scaffold" (the warm
    start, then the rounds: what ``ScaffoldServer(warm_start=True).fit``
    does, with the params read between) or "fedprox" (``FedProxServer``):
    16 non-IID clients, 3 pipelined rounds, all clients in one vmap, no
    client lost. It reaches no kernel, as in JAX: every launch counter must
    stand still over the phase."""
    from fl4health_tpu_torch.core.pytree import global_norm, tree_nbytes
    from fl4health_tpu_torch.server.servers import FedProxServer, scaffold_warm_start

    sim = build_alg_sim(kind, data, "cuda")
    fields = (("control_variates",) if kind == "scaffold"
              else ("drift_penalty_weight", "loss_drop_streak", "previous_loss"))
    init = {k: v.clone() for k, v in sim.global_params.items()}
    counters = lambda: [dict(c) for c in (fa.LAUNCHES, fa.WGMMA_LAUNCHES, dp.LAUNCHES)]  # noqa: E731
    before = counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    with recorded_states(sim, *fields) as states:
        if kind == "scaffold":
            scaffold_warm_start(sim)
            warm_kept_params = all(torch.equal(sim.global_params[k], v)
                                   for k, v in init.items())
            hist = sim.fit(ALG_ROUNDS)
        else:
            hist = FedProxServer(sim).fit(ALG_ROUNDS)
        torch.cuda.synchronize()
    wall = time.time() - t0
    after = counters()
    peak = torch.cuda.max_memory_allocated() / 2**30
    steps = sim._round_plan(1)[2].sum(axis=1).astype(int).tolist()
    for r in hist:
        values = (*r.fit_losses.values(), *r.eval_losses.values())
        if not all(np.isfinite(v) for v in values):
            fail(f"{kind} round {r.round}: non-finite losses {r.fit_losses} {r.eval_losses}")
        print(json.dumps({f"{kind}_round": r.round, "fit_losses": r.fit_losses,
                          "eval_loss": r.eval_losses["checkpoint"],
                          "eval_accuracy": r.eval_metrics["accuracy"],
                          "fit_dispatch_s": r.fit_elapsed_s,
                          "eval_dispatch_s": r.eval_elapsed_s}))
    moved = max(float((sim.global_params[k] - init[k]).abs().max()) for k in init)
    finite = all(torch.isfinite(v).all() for v in sim.global_params.values())
    res = {"main_path": f"{kind}_cifar_cnn", "rounds": ALG_ROUNDS, "wall_s": wall,
           "clients": ALG_CLIENTS, "train_rows": [d.n_train for d in data],
           "steps_per_client": steps, "n_params": sum(v.numel() for v in init.values()),
           "peak_mem_gib": peak, "max_param_change": moved,
           "launch_counters_moved": before != after}
    if kind == "scaffold":
        # the warm start's aggregate is the first: its variates are kept
        res["control_variate_norms"] = [float(global_norm(s["control_variates"]))
                                        for s in states]
        res["warm_start_kept_params"] = warm_kept_params
        res["extra_bytes"] = tree_nbytes(sim.client_states.extra)
        if not res["warm_start_kept_params"]:
            fail("scaffold: the warm start moved the global params")
        if len(states) != ALG_ROUNDS + 1 or not all(
                np.isfinite(n) and n > 0 for n in res["control_variate_norms"]):
            fail(f"scaffold: control variate norms {res['control_variate_norms']}")
    else:
        res["mu"] = [float(s["drift_penalty_weight"]) for s in states]
        res["loss_drop_streak"] = [int(s["loss_drop_streak"]) for s in states]
        if not all(r.fit_losses["penalty"] > 0 for r in hist[1:]):
            fail(f"fedprox: no drift penalty after round 1: {[r.fit_losses for r in hist]}")
    # under the strict policy: a client lost in these rounds ends the run
    res["warm_walls"] = pipeline_walls(sim)
    print(json.dumps(res))
    if not finite or moved <= 0:
        fail(f"{kind} global params after training: finite={finite}, max change {moved}")
    if min(steps) == max(steps):
        fail(f"{kind}: the clients are not uneven: {steps}")
    if before != after:
        fail(f"the {kind} path launched kernels: {before} -> {after}")
    return res


def dp_scaffold_main_path(dp) -> dict:
    """Full-width DP-SCAFFOLD of CifarNet, bf16 compute, the warm start and 2
    rounds under DpScaffoldServer, the DP launch counts set to 0 just before
    and read just after: (2 rounds + the warm start) x 5 steps, each one K1
    launch and one K2 launch a leaf for all 64 clients."""
    from fl4health_tpu_torch.core.pytree import global_norm
    from fl4health_tpu_torch.server.servers import DpScaffoldServer

    data = image_datasets(DP_CLIENTS, DP_TRAIN, DP_VAL, (32, 32, 3))
    sim = build_alg_sim("dp_scaffold", data, "cuda", local_steps=LOCAL_STEPS,
                        observability=telemetry_build())
    server = DpScaffoldServer(sim, noise_multiplier=DP_SIGMA, batch_size=BATCH,
                              warm_start=True, delta=1 / (DP_CLIENTS * DP_TRAIN))
    init = {k: v.clone() for k, v in sim.global_params.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dp.reset_launch_counts()
    t0 = time.time()
    with recorded_states(sim, "control_variates") as states:
        hist, epsilon = server.fit(DPS_ROUNDS)
        torch.cuda.synchronize()
    wall = time.time() - t0
    launches, copies = dict(dp.LAUNCHES), dict(dp.COPIES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    for r in hist:
        if not all(np.isfinite(v) for v in (*r.fit_losses.values(), *r.eval_losses.values())):
            fail(f"DP-SCAFFOLD round {r.round}: non-finite losses {r.fit_losses} "
                 f"{r.eval_losses}")
        print(json.dumps({"dp_scaffold_round": r.round, "fit_loss": r.fit_losses["backward"],
                          "clip_fraction": r.fit_losses["clip_fraction"],
                          "eval_loss": r.eval_losses["checkpoint"],
                          "eval_accuracy": r.eval_metrics["accuracy"],
                          "fit_dispatch_s": r.fit_elapsed_s,
                          "eval_dispatch_s": r.eval_elapsed_s}))
    moved = max(float((sim.global_params[k] - init[k]).abs().max()) for k in init)
    finite = all(torch.isfinite(v).all() for v in sim.global_params.values())
    steps = (DPS_ROUNDS + 1) * LOCAL_STEPS
    expected = {"dp_sq_norms": steps, "dp_scaled_sum": steps * len(CIFAR_LEAVES)}
    norms = [float(global_norm(s["control_variates"])) for s in states]
    walls = pipeline_walls(sim)
    print(json.dumps({"main_path": "dp_scaffold_cifar_cnn", "rounds": DPS_ROUNDS,
                      "warm_start": True, "wall_s": wall, "warm_walls": walls,
                      "train_examples_per_s": [WARM_ROUNDS * DP_CLIENTS * LOCAL_STEPS * BATCH
                                               / w for w in walls["pipelined_s"]],
                      # the accountant's arithmetic, not this run's
                      # guarantee: round 1 redraws the warm start's noise
                      "accountant_epsilon": epsilon, "epsilon_is_a_guarantee": False,
                      "full_participation_rounds": 1,
                      "control_variate_norms": norms, "peak_mem_gib": peak,
                      "max_param_change": moved, "launches": launches,
                      "expected_launches": expected, "per_example_copies": copies}))
    if not finite or moved <= 0:
        fail(f"DP-SCAFFOLD global params: finite={finite}, max change {moved}")
    if len(norms) != DPS_ROUNDS + 1 or not all(np.isfinite(n) and n > 0 for n in norms):
        fail(f"DP-SCAFFOLD control variate norms {norms}")
    if abs(epsilon - DPS_EPSILON) > 1e-9:
        fail(f"DP-SCAFFOLD accountant epsilon {epsilon!r}, the CPU accountant gives "
             f"{DPS_EPSILON!r}")
    if launches != expected:
        fail(f"DP-SCAFFOLD launches {launches}, expected {expected}")
    if any(copies.values()):
        fail(f"the DP-SCAFFOLD path copied per-example gradients: {copies}")
    return launches


def bert_datasets(cfg: dict, n_clients: int, n_rows: int, n_train: int,
                  first_key: int = 0, **kw) -> list:
    """Client i's rows from ``PRNGKey(first_key + i)``, drawn on the card as
    the JAX generator draws them, kept on the host as the simulation takes
    them."""
    from fl4health_tpu_torch import rng
    from fl4health_tpu_torch.datasets.synthetic import synthetic_text_classification
    from fl4health_tpu_torch.server.simulation import ClientDataset

    out = []
    for i in range(n_clients):
        x, y = (a.cpu() for a in synthetic_text_classification(
            rng.PRNGKey(first_key + i, "cuda"), n_rows, cfg["vocab_size"], cfg["max_len"],
            cfg["n_classes"], **kw))
        out.append(ClientDataset(x[:n_train], y[:n_train], x[n_train:], y[n_train:]))
    return out


def build_bert_sim(cfg: dict, data, dtype, device, seed, attention_fn, remat: bool,
                   client_lr: float, batch: int, local_steps: int, dropout_rate: float = 0.0,
                   **sim_kw):
    """Config 3's recipe: LoRA (rank 4) on the transformer, client
    ``masked_optimizer(adam)``, server ``FedOpt(adam(0.01))``,
    ``lora_exchanger``."""
    from fl4health_tpu_torch import optim
    from fl4health_tpu_torch.clients import engine
    from fl4health_tpu_torch.metrics import efficient
    from fl4health_tpu_torch.metrics.base import MetricManager
    from fl4health_tpu_torch.models.transformer import TransformerClassifier
    from fl4health_tpu_torch.server.simulation import FederatedSimulation
    from fl4health_tpu_torch.strategies.fedopt import FedOpt
    from fl4health_tpu_torch.utils.peft import (lora_exchanger, lora_trainable_mask,
                                                masked_optimizer)

    module = TransformerClassifier(**cfg, lora_rank=BERT_LORA, dtype=dtype, remat=remat,
                                   attention_fn=attention_fn, dropout_rate=dropout_rate)
    paths = {name.replace(".", "/"): None for name, _ in module.named_parameters()}
    return FederatedSimulation(
        logic=engine.ClientLogic(engine.from_module(module), engine.masked_cross_entropy),
        tx=masked_optimizer(optim.adam(client_lr), lora_trainable_mask(paths)),
        strategy=FedOpt(optim.adam(BERT_LR)), datasets=data, batch_size=batch,
        metrics=MetricManager((efficient.accuracy(),)), local_steps=local_steps, seed=seed,
        exchanger=lora_exchanger(), device=device, **sim_kw)


def card_vs_cpu(name: str, make_sim, rounds: int) -> dict:
    """The same run on the card and on the CPU from the same params: losses
    and params within 5e-4."""
    runs = []
    for device in ("cuda", "cpu"):
        sim = make_sim(device)
        if runs:
            sim.set_global_params({k: v.cpu() for k, v in runs[0][2].items()})
        init = {k: v.clone() for k, v in sim.global_params.items()}
        runs.append((sim.fit(rounds), sim.global_params, init))
    (gpu_hist, gpu_params, _), (cpu_hist, cpu_params, _) = runs
    for gr, cr in zip(gpu_hist, cpu_hist, strict=True):
        check(f"{name} fit loss r{gr.round}", torch.tensor(gr.fit_losses["backward"]),
              torch.tensor(cr.fit_losses["backward"]), 5e-4, 0)
        check(f"{name} eval loss r{gr.round}", torch.tensor(gr.eval_losses["checkpoint"]),
              torch.tensor(cr.eval_losses["checkpoint"]), 5e-4, 0)
    err = max(check(f"{name} param {k}", gpu_params[k].cpu(), cpu_params[k], 5e-4, 0)
              for k in cpu_params)
    return {"rounds": rounds, "fit_losses": [r.fit_losses["backward"] for r in gpu_hist],
            "max_param_abs_err": err}


def tiny_bert_parity(fa) -> None:
    """tests/smoke/harness.py's bert_lora_fedopt (3 clients, LoRA rank 4,
    masked adam(5e-3), FedOpt(adam(0.01)), batch 12, 6 steps, remat, f32)
    through flash attention: K3-K5 on the card (head dim 16, the CUDA-core
    route) against the plain version on the CPU, 2 rounds."""
    from fl4health_tpu_torch.kernels.flash_attention import flash_attention

    data = bert_datasets(TINY_BERT, 3, 48, 36, first_key=60, class_sep=2.5)
    fa.reset_launch_counts()
    res = card_vs_cpu("tiny bert_lora_fedopt", lambda device: build_bert_sim(
        TINY_BERT, data, torch.float32, device, 11, flash_attention, True, 5e-3, 12, 6), 2)
    launches = dict(fa.LAUNCHES)
    print(json.dumps({"tiny_parity": "bert_lora_fedopt, cuda kernels vs cpu plain",
                      **res, "launches": launches}))
    if min(launches.values()) == 0:
        fail(f"tiny bert_lora_fedopt: a kernel never ran on the card {launches}")


def dropout_parity() -> None:
    """The tiny config with dropout 0.1 (dense attention core, remat): one
    train call's dropout masks on the card equal the CPU's bit for bit, for
    every Dropout and the remat's recompute, and 2 federated rounds agree
    within 5e-4."""
    from fl4health_tpu_torch import rng
    from fl4health_tpu_torch.models import transformer as tr

    module = tr.TransformerClassifier(**TINY_BERT, lora_rank=BERT_LORA, remat=True,
                                      dropout_rate=0.1)
    params = module.init_params(torch.Generator().manual_seed(3))
    x = torch.randint(1, TINY_BERT["vocab_size"], (12, TINY_BERT["max_len"]),
                      generator=torch.Generator().manual_seed(4))
    x[3, 6:] = 0
    orig, masks = tr.dropout_mask, []  # one list of draws a device

    def recording(key, shape, rate):
        mask = orig(key, shape, rate)
        # the remat's recompute runs under torch.func.vjp's wrappers
        plain = mask
        while torch._C._functorch.is_functorch_wrapped_tensor(plain):
            plain = torch._C._functorch.get_unwrapped(plain)
        with torch._C._DisableFuncTorch():
            masks[-1].append(plain.cpu().clone())
        return mask

    tr.dropout_mask = recording
    try:
        for device in ("cuda", "cpu"):
            masks.append([])
            named = {k.replace("/", "."): v.to(device).requires_grad_(True)
                     for k, v in params.items()}
            out = torch.func.functional_call(module.to(device), named, (x.to(device),),
                                             {"train": True, "rng": rng.PRNGKey(9, device)})
            out[0]["prediction"].sum().backward()
    finally:
        tr.dropout_mask = orig
    card, cpu = masks
    if len(card) != 12 or len(cpu) != 12:
        fail(f"dropout: expected 12 draws a device (6 and the remat's 6), got "
             f"{len(card)} on the card and {len(cpu)} on the CPU")
    same = all(torch.equal(a, b) for a, b in zip(card, cpu))
    if not same:
        fail("dropout: the masks on the card differ from the CPU's")
    data = bert_datasets(TINY_BERT, 3, 48, 36, first_key=60, class_sep=2.5)
    res = card_vs_cpu("tiny dropout", lambda device: build_bert_sim(
        TINY_BERT, data, torch.float32, device, 11, None, True, 5e-3, 12, 6,
        dropout_rate=0.1), 2)
    print(json.dumps({"tiny_parity": "dropout 0.1, dense core, cuda vs cpu",
                      "masks_bit_identical": same, "mask_draws": len(card),
                      "keep_share": float(np.mean([m.float().mean() for m in card])),
                      **res}))


def bert_warm_start(sim) -> dict:
    """Config 3 from a file: write the simulation's initial params to a
    BERT-base-width ``.pt`` state dict in torch's Linear convention (2-D
    Dense kernels as ``[out, in]`` weights), re-initialize the model from
    another generator seed, warm-start it with ``warm_up_from_file(...,
    torch_linear_convention=True)`` and install the result; the warmed tree
    must equal the written one bit for bit, so the run goes on as before."""
    from fl4health_tpu_torch.preprocessing.checkpoint_io import warm_up_from_file

    written = {k: v.detach().cpu().clone() for k, v in sim.global_params.items()}
    state_dict = {}
    for path, leaf in written.items():
        dotted = path.replace("/", ".")
        if dotted.endswith(".kernel") and leaf.ndim == 2 and "embed" not in dotted.lower():
            state_dict[dotted[:-len("kernel")] + "weight"] = leaf.T.contiguous()
        else:
            state_dict[dotted] = leaf
    root = ckpt_dir("warm")
    path = os.path.join(root, "bert_base.pt")
    t0 = time.perf_counter()
    torch.save(state_dict, path)
    save_s = time.perf_counter() - t0
    fresh = sim.logic.model.init(torch.Generator().manual_seed(1))
    moved = sum(not torch.equal(fresh[k].cpu(), written[k]) for k in written)
    t0 = time.perf_counter()
    warmed = warm_up_from_file(fresh, path, torch_linear_convention=True)
    load_s = time.perf_counter() - t0
    file_bytes = os.path.getsize(path)
    drop_dirs(root)
    equal = set(warmed) == set(written) and all(
        warmed[k].dtype == written[k].dtype and torch.equal(warmed[k].cpu(), written[k])
        for k in written)
    out = {"file_bytes": file_bytes, "leaves": len(written),
           "transposed_leaves": sum(k.endswith(".weight") for k in state_dict),
           "fresh_leaves_apart": moved, "bit_equal": equal, "save_s": save_s,
           "warm_up_s": load_s}
    if not equal or moved == 0:
        fail(f"config 3 warm start: {out}")
    sim.set_global_params(warmed)
    return out


def bert_main_path(fa) -> dict:
    """bert_lora_fedopt_base: config 3 at BERT-base width, 4 clients, 2
    FedOpt rounds through K3-K5, pipelined under a strict failure policy."""
    from fl4health_tpu_torch.kernels.flash_attention import flash_attention
    from fl4health_tpu_torch.server.simulation import FailurePolicy
    from fl4health_tpu_torch.utils.peft import lora_trainable_mask

    steps, layers, batch = LOCAL_STEPS, BERT_CFG["n_layers"], BATCH
    data = bert_datasets(BERT_CFG, BERT_CLIENTS, BERT_TRAIN + BERT_VAL, BERT_TRAIN)
    sim = build_bert_sim(BERT_CFG, data, torch.bfloat16, "cuda", 0, flash_attention, False,
                         BERT_LR, batch, steps,
                         failure_policy=FailurePolicy(accept_failures=False))
    warm = bert_warm_start(sim)
    init = {k: v.clone() for k, v in sim.global_params.items()}
    trainable = lora_trainable_mask(init)
    frozen = [k for k, t in trainable.items() if not t]
    n_params, n_trainable = (sum(init[k].numel() for k in keys) for keys in
                             (init, [k for k in init if trainable[k]]))
    if (n_params, len(init), n_trainable) != (BERT_PARAMS, BERT_LEAVES, BERT_TRAINABLE):
        fail(f"config 3 tree: {n_params} params in {len(init)} leaves, {n_trainable} "
             f"trainable; expected {BERT_PARAMS}, {BERT_LEAVES}, {BERT_TRAINABLE}")

    def frozen_unmoved() -> bool:
        return all(torch.equal(sim.client_states.params[k],
                               init[k].expand_as(sim.client_states.params[k]))
                   for k in frozen)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    t0 = time.time()
    hist = sim.fit(BERT_ROUNDS)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches, wgmma = dict(fa.LAUNCHES), dict(fa.WGMMA_LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    for r in hist:
        if not all(np.isfinite(v) for v in (*r.fit_losses.values(),
                                              *r.eval_losses.values())):
            fail(f"config 3 round {r.round}: non-finite losses {r.fit_losses} "
                 f"{r.eval_losses}")
        print(json.dumps({
            "bert_round": r.round, "fit_loss": r.fit_losses["backward"],
            "eval_loss": r.eval_losses["checkpoint"],
            "eval_accuracy": r.eval_metrics["accuracy"],
            "fit_dispatch_s": r.fit_elapsed_s, "eval_dispatch_s": r.eval_elapsed_s}))
    # what a client sends: the adapters and the head, zeros elsewhere
    pushed = [int(sum((v != 0).sum() for v in sim.exchanger.push(
        {k: p[c] for k, p in sim.client_states.params.items()}).values()))
        for c in range(BERT_CLIENTS)]
    unmoved_after_fit = frozen_unmoved()
    # the server's frozen leaves drift by about lr a round (ROADMAP C: the
    # zeros a partial push sends become FedOpt's pseudo-gradient)
    server_drift = max(float((sim.global_params[k] - init[k]).abs().max()) for k in frozen)
    walls = pipeline_walls(sim)
    losses = [r.fit_losses["backward"] for r in sim.history]
    positions = BERT_CLIENTS * steps * batch * BERT_CFG["max_len"]
    real = sum(int((d.x_train[: steps * batch] > 0).sum()) for d in data)
    # per round, all clients folded into each launch by the vmap rules:
    # 5 steps x 12 layers (no remat) + one validation batch's forward
    expected = {"flash_fwd": BERT_ROUNDS * layers * (steps + 1),
                "flash_bwd_dq": BERT_ROUNDS * layers * steps,
                "flash_bwd_dkv": BERT_ROUNDS * layers * steps}
    print(json.dumps({"main_path": "bert_lora_fedopt_base", "rounds": BERT_ROUNDS,
                      "wall_s": wall, "warm_walls": walls,
                      "train_token_positions_per_s": [WARM_ROUNDS * positions / w
                                                      for w in walls["pipelined_s"]],
                      "train_real_tokens_per_s": [WARM_ROUNDS * real / w
                                                  for w in walls["pipelined_s"]],
                      "n_params": n_params, "n_leaves": len(init),
                      "n_trainable": n_trainable, "clients": BERT_CLIENTS,
                      "peak_mem_gib": peak, "fit_losses_all_rounds": losses,
                      "pushed_nonzero_per_client": pushed,
                      "frozen_leaves_unmoved_on_every_client": unmoved_after_fit,
                      "server_frozen_leaf_drift_max": server_drift,
                      "launches": launches, "expected_launches": expected,
                      "wgmma_launches": wgmma, "warm_start": warm}))
    if launches != expected:
        fail(f"config 3 launches {launches}, expected {expected}")
    if wgmma != launches:
        fail(f"config 3 tensor-core launches {wgmma}, expected all of {launches}")
    if not unmoved_after_fit or not frozen_unmoved():
        fail("config 3: a frozen leaf of a client's params moved")
    if pushed != [n_trainable] * BERT_CLIENTS:
        fail(f"config 3: non-zero pushed elements {pushed}, the trainable count is "
             f"{n_trainable}")
    if not losses[-1] < losses[0]:
        fail(f"config 3: the training loss did not fall over the rounds {losses}")
    return launches


def precision_main_path(fa, dp) -> dict:
    """precision_mnist: MnistNet (dtype=None) under no policy,
    PrecisionConfig("bf16") and PrecisionConfig("fp16") (dynamic loss
    scaling), 64 clients, 3 rounds each from the same params and seed."""
    from fl4health_tpu_torch import optim
    from fl4health_tpu_torch.clients import engine
    from fl4health_tpu_torch.core.pytree import tree_leaves
    from fl4health_tpu_torch.metrics import efficient
    from fl4health_tpu_torch.metrics.base import MetricManager
    from fl4health_tpu_torch.models.cnn import MnistNet
    from fl4health_tpu_torch.precision import PrecisionConfig
    from fl4health_tpu_torch.server.simulation import FailurePolicy, FederatedSimulation
    from fl4health_tpu_torch.strategies.fedavg import FedAvg

    data = image_datasets(PREC_CLIENTS, BATCH * LOCAL_STEPS, 64, (28, 28, 1))
    counters = lambda: [dict(c) for c in (fa.LAUNCHES, fa.WGMMA_LAUNCHES, dp.LAUNCHES)]  # noqa: E731
    before, init, arms = counters(), None, {}
    for name, precision in (("f32", None), ("bf16", PrecisionConfig("bf16")),
                            ("fp16", PrecisionConfig("fp16"))):
        sim = FederatedSimulation(
            logic=engine.ClientLogic(engine.from_module(MnistNet(input_shape=(28, 28, 1))),
                                     engine.masked_cross_entropy),
            tx=optim.sgd(0.05), strategy=FedAvg(), datasets=data, batch_size=BATCH,
            metrics=MetricManager((efficient.accuracy(),)), local_steps=LOCAL_STEPS,
            seed=0, precision=precision, device="cuda",
            failure_policy=FailurePolicy(accept_failures=False))
        if init is None:
            init = {k: v.clone() for k, v in sim.global_params.items()}
        sim.set_global_params({k: v.clone() for k, v in init.items()})
        torch.cuda.synchronize()
        t0 = time.time()
        hist = sim.fit(PREC_ROUNDS)
        torch.cuda.synchronize()
        wall = time.time() - t0
        st = sim.client_states
        masters = {str(x.dtype) for x in tree_leaves((st.params, st.opt_state,
                                                      sim.global_params))}
        arm = {"wall_s": wall, "fit_losses": [r.fit_losses["backward"] for r in hist],
               "eval_losses": [r.eval_losses["checkpoint"] for r in hist],
               "eval_accuracy": hist[-1].eval_metrics["accuracy"],
               "master_dtypes": sorted(masters)}
        if st.loss_scale is not None:
            arm["skipped_steps"] = float(st.loss_scale["skipped"].sum())
            arm["final_scale"] = [float(st.loss_scale["scale"].min()),
                                  float(st.loss_scale["scale"].max())]
        arm["warm_walls"] = pipeline_walls(sim)
        arms[name] = arm
    for name, arm in arms.items():
        # the final model on the validation rows (evaluated on the f32
        # masters), and the last round's mean training loss
        arm["final_eval_loss_gap_to_f32"] = abs(arm["eval_losses"][-1]
                                                - arms["f32"]["eval_losses"][-1])
        arm["final_fit_loss_gap_to_f32"] = abs(arm["fit_losses"][-1]
                                               - arms["f32"]["fit_losses"][-1])
    after = counters()
    print(json.dumps({"main_path": "precision_mnist", "rounds": PREC_ROUNDS,
                      "clients": PREC_CLIENTS, "arms": arms,
                      "launch_counters_moved": before != after}))
    for name, arm in arms.items():
        if not all(np.isfinite(v) for v in arm["fit_losses"] + arm["eval_losses"]):
            fail(f"precision_mnist {name}: non-finite losses {arm}")
        if arm["master_dtypes"] != ["torch.float32"]:
            fail(f"precision_mnist {name}: masters are {arm['master_dtypes']}, not f32")
        if not arm["fit_losses"][-1] < arm["fit_losses"][0]:
            fail(f"precision_mnist {name}: the loss did not fall {arm['fit_losses']}")
        if arm["final_eval_loss_gap_to_f32"] > PREC_LOSS_ATOL:
            fail(f"precision_mnist {name}: final eval loss "
                 f"{arm['final_eval_loss_gap_to_f32']} from f32's, beyond {PREC_LOSS_ATOL}")
    if before != after:
        fail(f"precision_mnist launched kernels: {before} -> {after}")
    return arms


# ---------------------------------------------------------------------------
# Config 5 (nnU-Net), the chunked route and the >32-client aggregate
# ---------------------------------------------------------------------------

def one_reduction_weighted_mean(stacked, weights):
    """The weighted mean above 32 clients as the previous slice summed it:
    the products in one ``sum(dim=0)``, whose order is not JAX's. Timed
    beside ``core.aggregate.weighted_mean``; nothing else calls it."""
    from fl4health_tpu_torch.core.pytree import tree_leaves, tree_map

    leaves = tree_leaves(stacked)
    n = leaves[0].shape[0]
    w = weights.to(device=leaves[0].device, dtype=torch.float32)
    flat = torch.cat([x.reshape(n, -1).float() for x in leaves], dim=1)
    out = (torch.where(w[:, None] > 0, flat, torch.zeros((), device=flat.device))
           * w[:, None]).sum(dim=0)
    pieces = iter(torch.split(out, [x[0].numel() for x in leaves]))
    return tree_map(lambda x: next(pieces).view(x.shape[1:]).to(x.dtype), stacked)


def aggregate_64() -> dict:
    """The aggregate at the DP path's 64 clients over the CifarNet tree: the
    windowed sum on the card equal to the CPU's bit for bit (both JAX's
    order), within f32 rounding of the one reduction, and both timed (20
    calls a timing)."""
    from fl4health_tpu_torch.core import aggregate as agg

    g = torch.Generator(device="cuda").manual_seed(64)
    packets = {k: torch.randn((DP_CLIENTS, *shape), generator=g, device="cuda")
               for k, shape in CIFAR_LEAVES.items()}
    counts = torch.arange(1, DP_CLIENTS + 1, dtype=torch.float32, device="cuda")
    mask = (torch.arange(DP_CLIENTS, device="cuda") % 7 != 3).float()
    w = agg.effective_weights(counts, mask)
    got = agg.weighted_mean(packets, w)
    cpu = agg.weighted_mean({k: v.cpu() for k, v in packets.items()}, w.cpu())
    if not all(torch.equal(got[k].cpu(), cpu[k]) for k in cpu):
        fail("aggregate_64: the windowed sum on the card differs from the CPU's")
    old = one_reduction_weighted_mean(packets, w)
    err = max(check(f"aggregate_64 {k}", got[k], old[k], 1e-6, 1e-5) for k in got)
    res = {"phase": "aggregate_64", "clients": DP_CLIENTS,
           "elements": sum(v[0].numel() for v in packets.values()),
           "windowed_us": 1e3 * cuda_ms(lambda: agg.weighted_mean(packets, w), calls=20),
           "one_reduction_us": 1e3 * cuda_ms(
               lambda: one_reduction_weighted_mean(packets, w), calls=20),
           "card_equals_cpu": True, "max_abs_diff_vs_one_reduction": err}
    print(json.dumps(res))
    return res


def aggregate_walls(sim, rounds: int = WARM_ROUNDS) -> dict:
    """Warm walls of ``rounds`` rounds with the windowed aggregate and with
    the one reduction swapped in, in turns."""
    from fl4health_tpu_torch.core import aggregate as agg

    windowed = agg.weighted_mean
    walls = {"windowed_s": [], "one_reduction_s": []}
    try:
        for arm in ("windowed", "one_reduction", "one_reduction", "windowed"):
            agg.weighted_mean = windowed if arm == "windowed" else one_reduction_weighted_mean
            torch.cuda.synchronize()
            t0 = time.time()
            sim.fit(rounds)
            torch.cuda.synchronize()
            walls[f"{arm}_s"].append(time.time() - t0)
    finally:
        agg.weighted_mean = windowed
    return {"rounds": rounds, **walls}


def synth_volumes(n: int, size: int, seed: int):
    """tests/smoke/harness.py's synthetic spheres: ``n`` volumes of
    ``size``^3, one sphere each (label 1) in a channel of N(0, 0.3) noise."""
    g = np.random.default_rng(seed)
    vols, segs = [], []
    coords = np.stack(np.meshgrid(*[np.arange(size)] * 3, indexing="ij"), -1).astype(float)
    for _ in range(n):
        c = np.asarray([g.uniform(size * 0.3, size * 0.7) for _ in range(3)])
        r = size * g.uniform(0.2, 0.3)
        seg = (np.sqrt(((coords - c) ** 2).sum(-1)) < r).astype(np.int32)
        vols.append((g.normal(0, 0.3, (size,) * 3)[..., None] + seg[..., None]).astype(
            np.float32))
        segs.append(seg)
    return vols, segs


def busy_share(fn) -> dict:
    """One call of ``fn`` under ``torch.profiler``: its synchronised wall
    (the profiler's cost included), the union of the device's kernel,
    copy and memset intervals over it, and the kernels with the most
    device time."""
    import collections
    import tempfile

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall = time.time() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "trace.json")
        prof.export_chrome_trace(path)
        events = json.loads(Path(path).read_text())["traceEvents"]
    device = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    busy, end = 0.0, -1.0
    for a, b in sorted((e["ts"], e["ts"] + e["dur"]) for e in device):
        if b > end:
            busy += b - max(a, end)
            end = b
    by_name = collections.Counter()
    for e in device:
        by_name[e["name"][:80]] += e["dur"] / 1e6
    return {"wall_s": wall, "device_busy_s": busy / 1e6, "busy_share": busy / 1e6 / wall,
            "device_ops": len(device),
            "top_device_s": [[n, t] for n, t in by_name.most_common(6)]}


class ModeRecorder:
    """A reporter that keeps each report's ``execution_mode``."""

    def __init__(self):
        self.modes = []

    def report(self, data, round=None, epoch=None, step=None):
        if "execution_mode" in data:
            self.modes.append((round, data["execution_mode"],
                               data.get("execution_mode_reason")))

    def shutdown(self):
        pass


def build_nnunet_server(size: int, device: str, augment: bool, rounds: int,
                        shrink: bool = False, **sim_kw):
    """tests/smoke/harness.py's nnunet_synthetic at volume size ``size``:
    two clients' plans handshake through ``NnunetServer``; their builder
    cuts 10 patches a client (8 train, 2 val) and runs 4 local steps of
    ``nnunet_optimizer(5e-3)`` over ``rounds`` rounds, FedAvg, batch from
    the plans. ``shrink`` divides the features by 4 (the smoke config's
    CPU size)."""
    from fl4health_tpu_torch.clients import engine
    from fl4health_tpu_torch.clients.nnunet import (NnunetClientLogic,
                                                    make_nnunet_properties_provider)
    from fl4health_tpu_torch.metrics import efficient
    from fl4health_tpu_torch.metrics.base import MetricManager
    from fl4health_tpu_torch.models.unet import deep_supervision_strides, unet_from_plans
    from fl4health_tpu_torch.nnunet import extract_patch_dataset, nnunet_optimizer
    from fl4health_tpu_torch.server.nnunet import NnunetServer
    from fl4health_tpu_torch.server.simulation import ClientDataset, FederatedSimulation
    from fl4health_tpu_torch.strategies.fedavg import FedAvg

    client_data = [synth_volumes(NNU_VOLUMES, size, 10), synth_volumes(NNU_VOLUMES, size, 20)]
    providers = [make_nnunet_properties_provider(v, [(1.0, 1.0, 1.0)] * len(v), s)
                 for v, s in client_data]

    def sim_builder(plans, n_in, n_heads):
        cfg = plans["configurations"]["3d_fullres"]
        if shrink:
            cfg["features_per_stage"] = [max(f // 4, 8) for f in cfg["features_per_stage"]]
        logic = NnunetClientLogic(
            engine.from_module(unet_from_plans(plans, n_in, n_heads)),
            ds_strides=deep_supervision_strides(plans), augment=augment)
        datasets = []
        for i, (v, s) in enumerate(client_data):
            x, y = extract_patch_dataset(v, s, plans, n_patches=NNU_PATCHES, seed=i)
            datasets.append(ClientDataset(x[:NNU_TRAIN], y[:NNU_TRAIN], x[NNU_TRAIN:],
                                          y[NNU_TRAIN:]))
        return FederatedSimulation(
            logic=logic, tx=nnunet_optimizer(NNU_LR, rounds * NNU_STEPS), strategy=FedAvg(),
            datasets=datasets, batch_size=int(cfg["batch_size"]),
            metrics=MetricManager((efficient.segmentation_dice(n_heads),)),
            local_steps=NNU_STEPS, seed=0, extra_loss_keys=("dice", "ce"), device=device,
            **sim_kw)

    return NnunetServer(config={"n_server_rounds": rounds}, property_providers=providers,
                        sim_builder=sim_builder)


def tiny_nnunet_sim(device: str, augment: bool, **sim_kw):
    """The nnunet_synthetic smoke config's simulation (12^3, features / 4),
    its plans negotiated through ``NnunetServer``'s handshake."""
    server = build_nnunet_server(TINY_NNU_SIZE, device, augment, rounds=2, shrink=True,
                                 **sim_kw)
    server.update_before_fit()
    return server.sim_builder(server.plans, server.num_input_channels,
                              server.num_segmentation_heads)


def tiny_nnunet_parity() -> dict:
    """The nnunet_synthetic smoke config's sizes for 2 rounds on the card
    and on the CPU from the same params, with and without augmentation:
    losses and params within 5e-4. cuDNN's TF32 is off (the script turns
    it off for every phase but the full-width one)."""
    if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
        fail("tiny nnU-Net parity must run with TF32 off")
    out = {"phase": "tiny_nnunet_parity", "cudnn_allow_tf32": False}
    for augment in (False, True):
        out[f"augment_{augment}"] = card_vs_cpu(
            f"tiny nnU-Net (augment={augment})",
            lambda device, a=augment: tiny_nnunet_sim(device, a), 2)
    print(json.dumps(out))
    return out


def history_equal(a, b) -> bool:
    fields = ("fit_losses", "fit_metrics", "eval_losses", "eval_metrics")
    return ([r.round for r in a.history] == [r.round for r in b.history]
            and all(getattr(x, f) == getattr(y, f) for x, y in zip(a.history, b.history)
                    for f in fields))


def states_equal(a, b) -> bool:
    from fl4health_tpu_torch.core.pytree import tree_leaves

    return all(torch.equal(x, y) for x, y in zip(
        tree_leaves((a.server_state, a.client_states)),
        tree_leaves((b.server_state, b.client_states))))


def chunked_vs_pipelined(dp) -> dict:
    """The chunked route against the pipelined one on the card, cuDNN
    deterministic in this phase only: the DP path (64 clients, so the
    windowed aggregate, and K1/K2) and the tiny nnU-Net config with
    augmentation, each 2 rounds from the same seed with ``execution_mode``
    "auto" (which must take the chunked route) and "pipelined": histories,
    server and client states equal bit for bit; then both routes' warm
    walls in turns."""
    from fl4health_tpu_torch.server import simulation as tsim

    dp_data = image_datasets(DP_CLIENTS, DP_TRAIN, DP_VAL, (32, 32, 3))
    builds = {
        "dp_cifar_cnn": lambda mode: build_dp_sim(dp_data, torch.bfloat16, "cuda", DP_SIGMA,
                                                  seed=0, execution_mode=mode),
        "nnunet_synthetic": lambda mode: tiny_nnunet_sim("cuda", True, execution_mode=mode),
    }
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    out = {"phase": "chunked_vs_pipelined", "cudnn_deterministic": True}
    try:
        for name, build in builds.items():
            auto, piped = build("auto"), build("pipelined")
            mode = auto._select_execution_mode(2)
            if mode[0] != tsim.EXEC_CHUNKED:
                fail(f"{name}: execution_mode='auto' took {mode}")
            auto.fit(2)
            piped.fit(2)
            torch.cuda.synchronize()
            equal = history_equal(auto, piped) and states_equal(auto, piped)
            if not equal:
                fail(f"{name}: the chunked history or state differs from the pipelined one")
            out[name] = {"mode": list(mode), "bit_equal": equal,
                         "fit_losses": [r.fit_losses["backward"] for r in auto.history],
                         "warm_walls": mode_walls(auto)}
    finally:
        torch.backends.cudnn.deterministic = deterministic
    print(json.dumps(out))
    return out


def nnunet_main_path(fa, dp) -> dict:
    """BASELINE.json config 5 at nnU-Net's published width through
    ``NnunetServer`` (plans negotiated from a client) and the default
    ``execution_mode``, which must take the chunked route: 1 cold round and
    2 warm, the launch counts set to 0 before and read after (none of
    K1-K5, as in JAX); losses finite and falling; then rounds through the
    client vmap and the loop over clients in turns. cuDNN may use TF32, as
    PyTorch's default has it; printed."""
    from fl4health_tpu_torch.server import simulation as tsim

    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        recorder = ModeRecorder()
        t0 = time.time()
        server = build_nnunet_server(NNU_SIZE, "cuda", augment=True, rounds=NNU_ROUNDS,
                                     reporters=[recorder])
        server.update_before_fit()
        setup_s = time.time() - t0
        cfg = server.plans["configurations"]["3d_fullres"]
        shape = {"features_per_stage": cfg["features_per_stage"],
                 "patch_size": cfg["patch_size"], "batch_size": cfg["batch_size"],
                 "n_stages": cfg["n_stages"], "kernel_sizes": cfg["kernel_sizes"][0]}
        if (cfg["features_per_stage"] != NNU_FEATURES or cfg["patch_size"] != [NNU_SIZE] * 3
                or cfg["batch_size"] != 2):
            fail(f"nnU-Net plans {shape}: not the published width at a 128^3 patch")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launch_counts()
        dp.reset_launch_counts()
        t0 = time.time()
        server.fit(1)
        torch.cuda.synchronize()
        cold = time.time() - t0
        sim = server.sim
        warm = []
        for _ in range(NNU_WARM):
            t0 = time.time()
            sim.fit(1)
            torch.cuda.synchronize()
            warm.append(time.time() - t0)
        launches = {**fa.LAUNCHES, **dp.LAUNCHES}
        peak = torch.cuda.max_memory_allocated() / 2**30
        hist = list(sim.history)
        profiled = busy_share(lambda: sim.fit(1))
        for r in hist:
            values = [*r.fit_losses.values(), *r.eval_losses.values(), *r.eval_metrics.values()]
            if not all(np.isfinite(v) for v in values):
                fail(f"nnU-Net round {r.round}: non-finite values {r}")
            print(json.dumps({"nnunet_round": r.round, "fit_losses": r.fit_losses,
                              "eval_losses": r.eval_losses,
                              "seg_dice": r.eval_metrics["seg_dice"],
                              "fit_elapsed_s": r.fit_elapsed_s,
                              "eval_elapsed_s": r.eval_elapsed_s}))
        falling = (hist[-1].fit_losses["backward"] < hist[0].fit_losses["backward"]
                   and hist[-1].eval_losses["checkpoint"] < hist[0].eval_losses["checkpoint"])
        modes = {m for _, m, _ in recorder.modes}
        n_params = sum(v.numel() for v in sim.global_params.values())
        # the client axis: rounds through the vmap and the loop, in turns
        vmapped = (sim._fit_round, sim._eval_round)
        looped = sim._build_round_fns(tsim.loop_clients)
        axis = {"vmap_clients_s": [], "loop_clients_s": []}
        axis_peak = {"vmap_clients": 0.0, "loop_clients": 0.0}
        for arm in ("vmap_clients", "loop_clients", "loop_clients", "vmap_clients"):
            sim._fit_round, sim._eval_round = vmapped if arm == "vmap_clients" else looped
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.time()
            sim.fit(1)
            torch.cuda.synchronize()
            axis[f"{arm}_s"].append(time.time() - t0)
            axis_peak[arm] = max(axis_peak[arm], torch.cuda.max_memory_allocated() / 2**30)
        sim._fit_round, sim._eval_round = vmapped
        voxels = NNU_CLIENTS * NNU_STEPS * int(cfg["batch_size"]) * NNU_SIZE ** 3
        res = {"main_path": "nnunet_fullres", "plans": shape, "n_params": n_params,
               "clients": NNU_CLIENTS, "local_steps": NNU_STEPS, "augment": True,
               "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
               "cuda_matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
               "execution_modes": sorted(modes), "setup_s": setup_s, "cold_round_s": cold,
               "warm_round_s": warm, "train_voxels_per_s": [voxels / w for w in warm],
               "peak_mem_gib": peak, "profiled_round": profiled, "launches": launches,
               "falling": falling,
               "client_axis_walls": axis, "client_axis_peak_gib": axis_peak}
        print(json.dumps(res))
        res["sim"] = sim  # for nnunet_inference
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    if modes != {tsim.EXEC_CHUNKED}:
        fail(f"nnU-Net fit took {recorder.modes}, not the chunked route")
    if any(launches.values()):
        fail(f"the nnU-Net path launched kernels: {launches}")
    if not falling:
        fail("nnU-Net losses did not fall over the first 3 rounds")
    return res




# -- the cohort slice: cohort-slot execution over a client registry and the
# compressed exchange ----------------------------------------------------
COHORT_SLOTS, COHORT_ROUNDS, COHORT_POOL = 64, 3, 50_000  # the pool: CIFAR-10's train size
COHORT_SIZES = (1_000, 100_000)  # bench.py's smallest and largest registries
COMPRESSION = dict(topk_fraction=0.1, error_feedback=True, quant_bits=8, seed=3)


def host_rss_gib() -> dict:
    """This process's resident host memory now and at its peak, GiB."""
    import resource

    with open("/proc/self/status") as f:
        now_kib = next(int(line.split()[1]) for line in f if line.startswith("VmRSS:"))
    return {"host_rss_gib": now_kib / 2**20,
            "host_rss_peak_gib": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20}


def cifar_pool() -> tuple:
    """The registry's 50,000-row pool: ``synthetic_classification`` drawn on
    the card (the JAX preset's generator; the CPU takes ~1 min for it),
    copied to the host once."""
    from fl4health_tpu_torch import rng
    from fl4health_tpu_torch.datasets.synthetic import synthetic_classification

    t0 = time.time()
    x, y = synthetic_classification(rng.PRNGKey(0, "cuda"), COHORT_POOL, (32, 32, 3), 10)
    x, y = x.cpu().numpy(), y.cpu().numpy()
    print(json.dumps({"cohort_pool": list(x.shape), "pool_bytes": x.nbytes + y.nbytes,
                      "pool_s": time.time() - t0}))
    return x, y


def build_cohort_sim(source, n: int, **sim_kw):
    """``dp_cifar_cnn``'s model and client over a registry: 64 slots,
    ``FixedFractionManager(N, 64 / N)``, ``execution_mode`` "auto"."""
    from fl4health_tpu_torch.server.client_manager import FixedFractionManager
    from fl4health_tpu_torch.server.registry import CohortConfig

    return build_dp_sim(source, torch.bfloat16, "cuda", DP_SIGMA, seed=0,
                        cohort=CohortConfig(slots=COHORT_SLOTS),
                        client_manager=FixedFractionManager(n, COHORT_SLOTS / n), **sim_kw)


def cohort_dp_cifar_cnn(fa, dp, pool) -> dict:
    """``cohort_dp_cifar_cnn``: the DP path's model and client over a
    Dirichlet(0.5) registry of the pool at N 1,000 and N 100,000 clients,
    64 slots, through the chunked cohort route (in-graph draws): a cold
    round, then 3 warm rounds with the launch counts and the peak set to 0
    before and read after. 5 K1 and 40 K2 launches a round, none of K3-K5;
    finite losses; the round walls, peak, staging facts and host memory at
    both sizes, and their ratios."""
    from fl4health_tpu_torch.datasets.registry_presets import dirichlet_registry_source
    from fl4health_tpu_torch.server import simulation as tsim

    x, y = pool
    out, sources = {"phase": "cohort_dp_cifar_cnn", "slots": COHORT_SLOTS}, {}
    for n in COHORT_SIZES:
        t0 = time.time()
        source = sources[n] = dirichlet_registry_source(x, y, n, beta=0.5, seed=0)
        build_s = time.time() - t0
        sizes = source.train_sizes()
        sim = build_cohort_sim(source, n)
        mode = sim._select_execution_mode(COHORT_ROUNDS)
        if mode[0] != tsim.EXEC_CHUNKED:
            fail(f"cohort N={n}: execution_mode='auto' took {mode}")
        torch.cuda.synchronize()
        t0 = time.time()
        sim.fit(1)  # cold: the first vmapped round
        torch.cuda.synchronize()
        cold_s = time.time() - t0
        torch.cuda.reset_peak_memory_stats()
        dp.reset_launch_counts()
        fa.reset_launch_counts()
        t0 = time.time()
        sim.fit(COHORT_ROUNDS)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = {**dp.LAUNCHES, **fa.LAUNCHES}
        peak = torch.cuda.max_memory_allocated() / 2**30
        expected = {"dp_sq_norms": COHORT_ROUNDS * LOCAL_STEPS,
                    "dp_scaled_sum": COHORT_ROUNDS * LOCAL_STEPS * len(CIFAR_LEAVES),
                    "flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
        if launches != expected:
            fail(f"cohort N={n}: launches {launches}, expected {expected}")
        for r in sim.history:
            if not all(np.isfinite(v) for v in (*r.fit_losses.values(),
                                                  *r.eval_losses.values())):
                fail(f"cohort N={n} round {r.round}: non-finite losses {r.fit_losses}")
        warm = sim.round_metrics[-COHORT_ROUNDS:]
        if any(m["cohort_valid"] != COHORT_SLOTS or m["cohort_draw"] != "in_graph"
               for m in warm):
            fail(f"cohort N={n}: round facts {warm}")
        out[f"n_{n}"] = {
            "registry_size": n, "registry_build_s": build_s,
            "train_rows_min_mean_max": [int(sizes.min()), float(sizes.mean()),
                                        int(sizes.max())],
            "mode": list(mode), "cold_round_s": cold_s, "warm_rounds": COHORT_ROUNDS,
            "warm_wall_s": wall, "warm_round_s": wall / COHORT_ROUNDS,
            "peak_mem_gib": peak, "launches": launches,
            "fit_losses": [r.fit_losses["backward"] for r in sim.history],
            "eval_losses": [r.eval_losses["checkpoint"] for r in sim.history],
            "registry_dirty_rows": sim.registry.dirty_rows,
            "round_facts": {k: warm[-1][k] for k in (
                "stage_ms", "gather_ms", "scatter_ms", "staged_bytes", "pull_bytes",
                "pull_ms", "rounds_per_dispatch", "cohort_draw")},
            **host_rss_gib()}
        del sim
        torch.cuda.empty_cache()
    small, large = (out[f"n_{n}"] for n in COHORT_SIZES)
    out["peak_ratio_100k_to_1k"] = large["peak_mem_gib"] / small["peak_mem_gib"]
    out["round_wall_ratio_100k_to_1k"] = large["warm_round_s"] / small["warm_round_s"]
    print(json.dumps(out))
    out["sources"] = sources
    return out


def registry_rows_equal(a, b) -> bool:
    """Two registries store the same rows, bit for bit."""
    stores = [(a._client_store, b._client_store), (a._strategy_store, b._strategy_store)]
    return all(sa._rows.keys() == sb._rows.keys() and all(
        len(sa._rows[k]) == len(sb._rows[k])
        and all(np.array_equal(x, y) for x, y in zip(sa._rows[k], sb._rows[k]))
        for k in sa._rows) for sa, sb in stores)


def cohort_chunked_vs_pipelined(source) -> dict:
    """``cohort_chunked_vs_pipelined``, cuDNN deterministic in this phase
    only: N 1,000 with the compressed exchange (top-k 0.1, 8 bits, error
    feedback) through the chunked cohort route ("auto") and the pipelined
    one, 3 rounds each: histories, server and client states, and the
    registry's client and error-feedback rows equal bit for bit; then both
    routes' warm walls in turns, ``WARM_ROUNDS`` rounds each."""
    from fl4health_tpu_torch.compression.config import CompressionConfig
    from fl4health_tpu_torch.server import simulation as tsim

    n = COHORT_SIZES[0]
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        sims = {mode: build_cohort_sim(source, n, execution_mode=mode,
                                       compression=CompressionConfig(**COMPRESSION))
                for mode in ("auto", "pipelined")}
        auto, piped = sims["auto"], sims["pipelined"]
        mode = auto._select_execution_mode(COHORT_ROUNDS)
        if mode[0] != tsim.EXEC_CHUNKED:
            fail(f"cohort_chunked_vs_pipelined: 'auto' took {mode}")
        auto.fit(COHORT_ROUNDS)
        piped.fit(COHORT_ROUNDS)
        torch.cuda.synchronize()
        equal = {"history": history_equal(auto, piped), "states": states_equal(auto, piped),
                 "registry_rows": registry_rows_equal(auto.registry, piped.registry)}
        if not all(equal.values()):
            fail(f"cohort_chunked_vs_pipelined: the routes differ: {equal}")
        if not auto.registry.has_strategy_rows or auto.registry._strategy_store.dirty == 0:
            fail("cohort_chunked_vs_pipelined: no error-feedback rows in the registry")
        out = {"phase": "cohort_chunked_vs_pipelined", "registry_size": n,
               "cudnn_deterministic": True, "compression": COMPRESSION,
               "mode": list(mode), "bit_equal": equal,
               "dirty_rows": [auto.registry.dirty_rows,
                              auto.registry._strategy_store.dirty],
               "fit_losses": [r.fit_losses["backward"] for r in auto.history],
               "round_facts": {m: {k: s.round_metrics[-1][k] for k in (
                   "stage_ms", "gather_ms", "scatter_ms", "pull_bytes", "pull_ms")}
                   for m, s in sims.items()},
               "warm_walls": mode_walls(auto)}
    finally:
        torch.backends.cudnn.deterministic = deterministic
    print(json.dumps(out))
    return out


def compressed_dp_cifar_cnn() -> dict:
    """``compressed_dp_cifar_cnn``: the dense DP path (64 clients, 2
    rounds a reading) without and with the compressed exchange, warm walls
    in turns (plain, compressed, compressed, plain; bench.py's
    ``round_s_plain``/``round_s_compressed``); the update's logical and
    estimated wire bytes; and one client's ``compress_update`` over the
    CifarNet tree on the card equal to the CPU's bit for bit."""
    from fl4health_tpu_torch import rng
    from fl4health_tpu_torch.compression import codecs
    from fl4health_tpu_torch.compression.config import CompressionConfig

    cfg = CompressionConfig(**COMPRESSION)
    data = image_datasets(DP_CLIENTS, DP_TRAIN, DP_VAL, (32, 32, 3))
    sims = {"plain": build_dp_sim(data, torch.bfloat16, "cuda", DP_SIGMA, seed=0),
            "compressed": build_dp_sim(data, torch.bfloat16, "cuda", DP_SIGMA, seed=0,
                                       compression=cfg)}
    for sim in sims.values():
        sim.fit(1)  # cold
    walls = {"plain_s": [], "compressed_s": []}
    for name in ("plain", "compressed", "compressed", "plain"):
        torch.cuda.synchronize()
        t0 = time.time()
        sims[name].fit(WARM_ROUNDS)
        torch.cuda.synchronize()
        walls[f"{name}_s"].append(time.time() - t0)
    for name, sim in sims.items():
        if not all(np.isfinite(r.fit_losses["backward"]) for r in sim.history):
            fail(f"compressed_dp_cifar_cnn {name}: non-finite losses")
    params = sims["plain"].global_params
    # one client's update over the CifarNet tree: the card's codec equals
    # the CPU's (the same draws, sort and arithmetic)
    gen = torch.Generator().manual_seed(0)
    update = {k: 0.01 * torch.randn(v.shape, generator=gen) for k, v in params.items()}
    residual = {k: 0.001 * torch.randn(v.shape, generator=gen) for k, v in params.items()}
    runs = [codecs.compress_update({k: v.to(dev) for k, v in update.items()},
                                   {k: v.to(dev) for k, v in residual.items()},
                                   rng.PRNGKey(11, dev), cfg) for dev in ("cuda", "cpu")]
    codec_equal = all(torch.equal(runs[0][i][k].cpu(), runs[1][i][k])
                      for i in (0, 1) for k in update)
    if not codec_equal:
        fail("compress_update on the card differs from the CPU's")
    out = {"phase": "compressed_dp_cifar_cnn", "clients": DP_CLIENTS,
           "compression": COMPRESSION, "rounds_a_reading": WARM_ROUNDS, "walls": walls,
           "round_s_plain": [w / WARM_ROUNDS for w in walls["plain_s"]],
           "round_s_compressed": [w / WARM_ROUNDS for w in walls["compressed_s"]],
           "logical_nbytes": codecs.logical_nbytes(params),
           "estimate_wire_nbytes": codecs.estimate_wire_nbytes(params, cfg),
           "codec_card_equals_cpu": codec_equal,
           "fit_losses": {n: [r.fit_losses["backward"] for r in s.history]
                          for n, s in sims.items()}}
    print(json.dumps(out))
    return out


def tiny_cohort_parity() -> dict:
    """A tiny cohort run (6 clients, 3 slots, FixedFractionManager(6, 0.5),
    the chunked route, f32 DP at noise 0: K1/K2 on the card) on the card and
    the CPU from the same params: within 5e-4."""
    from fl4health_tpu_torch.server.client_manager import FixedFractionManager
    from fl4health_tpu_torch.server.registry import CohortConfig

    data = image_datasets(6, 16, 8, (32, 32, 3))
    out = card_vs_cpu("tiny_cohort", lambda device: build_dp_sim(
        data, torch.float32, device, 0.0, seed=3, batch=8, local_steps=2,
        cohort=CohortConfig(slots=3), client_manager=FixedFractionManager(6, 0.5)), 3)
    print(json.dumps({"tiny_cohort_parity": "cuda vs cpu", **out}))
    return out


# The async slice: dp_cifar_cnn under bench.py:1430 timed_async_block's
# recipe (a buffer of half the cohort, jitter 0.05, two clients at 5x compute
# time, max(2 * TIMED_ROUNDS, 6) events); over the registry, 4 events
ASYNC_EVENTS, ASYNC_BUFFER, ASYNC_SLOW, ASYNC_COHORT_EVENTS = 6, 32, 5.0, 4


def async_recipe(slow: tuple = (0, 1)) -> tuple:
    """The ``AsyncConfig`` (buffer ``ASYNC_BUFFER``, jitter 0.05) and the
    ``FaultPlan`` of the slow clients (5x compute time)."""
    from fl4health_tpu_torch.resilience.faults import ClientFault, FaultPlan
    from fl4health_tpu_torch.server.async_schedule import AsyncConfig

    return (AsyncConfig(buffer_size=ASYNC_BUFFER, compute_jitter=0.05),
            FaultPlan(client_faults=(ClientFault(clients=slow, kind="slow", scale=ASYNC_SLOW),)))


def tiny_mlp_sim(device: str, mode: str = "auto", n: int = 4, **sim_kw):
    """tests/server/test_async_fit.py's recipe: an Mlp (12 hidden) over
    ``n`` uneven clients of 6 features and 3 classes (numpy, seed 0), batch 8,
    one local epoch of SGD(0.05), FedAvg unless ``strategy`` is given."""
    from fl4health_tpu_torch import optim
    from fl4health_tpu_torch.clients import engine
    from fl4health_tpu_torch.metrics import efficient
    from fl4health_tpu_torch.metrics.base import MetricManager
    from fl4health_tpu_torch.models.cnn import Mlp
    from fl4health_tpu_torch.server.simulation import ClientDataset, FederatedSimulation
    from fl4health_tpu_torch.strategies.fedavg import FedAvg

    r, data = np.random.default_rng(0), []
    for i in range(n):
        m = 40 - 2 * (i % 3)
        x = r.standard_normal((m, 6)).astype(np.float32)
        y = r.integers(0, 3, m).astype(np.int32)
        data.append(ClientDataset(x[:m - 8], y[:m - 8], x[m - 8:], y[m - 8:]))
    return FederatedSimulation(
        logic=engine.ClientLogic(engine.from_module(Mlp(6, (12,), 3)),
                                 engine.masked_cross_entropy),
        tx=optim.sgd(0.05), strategy=sim_kw.pop("strategy", None) or FedAvg(), datasets=data,
        batch_size=8, metrics=MetricManager((efficient.accuracy(),)), local_epochs=1,
        seed=5, execution_mode=mode, device=device, **sim_kw)


def tiny_async_parity() -> dict:
    """``tiny_async_parity``: buffered-async runs of the tiny Mlp recipe, 4
    events, on the card through each route and on the CPU, from the same
    params: stragglers (buffer 2 of 4, jitter 0.05, seed 3, client 0 at 5x),
    dropout beside a straggler, a scaling attacker under RobustFedAvg's
    median and trimmed mean (buffer 3), and async over a 6-client registry in
    3 seats (buffer 2, the seats swapping). Card within 5e-4 of the CPU;
    the card's pipelined and chunked routes equal bit for bit."""
    from fl4health_tpu_torch.resilience import aggregators
    from fl4health_tpu_torch.resilience.faults import ClientFault, FaultPlan
    from fl4health_tpu_torch.server.async_schedule import AsyncConfig
    from fl4health_tpu_torch.server.registry import CohortConfig

    slow = ClientFault(clients=(0,), kind="slow", scale=5.0)
    cases = {
        "stragglers": dict(async_config=AsyncConfig(buffer_size=2, compute_jitter=0.05, seed=3),
                           fault_plan=FaultPlan(client_faults=(slow,))),
        "dropout": dict(async_config=AsyncConfig(buffer_size=2, compute_jitter=0.05),
                        fault_plan=FaultPlan(client_faults=(
                            ClientFault(clients=(1,), kind="dropout", probability=0.5),
                            ClientFault(clients=(0,), kind="slow", scale=4.0)))),
        "scale_median": dict(async_config=AsyncConfig(buffer_size=3, compute_jitter=0.05),
                             fault_plan=FaultPlan(client_faults=(
                                 ClientFault(clients=(1,), kind="scale", scale=5.0), slow)),
                             strategy=lambda: aggregators.RobustFedAvg("median")),
        "scale_trimmed_mean": dict(
            async_config=AsyncConfig(buffer_size=3, compute_jitter=0.05),
            fault_plan=FaultPlan(client_faults=(
                ClientFault(clients=(1,), kind="scale", scale=5.0), slow)),
            strategy=lambda: aggregators.RobustFedAvg("trimmed_mean", trim_fraction=0.25)),
        "registry": dict(async_config=AsyncConfig(buffer_size=2, compute_jitter=0.05),
                         fault_plan=FaultPlan(client_faults=(slow,)),
                         cohort=CohortConfig(slots=3), n=6),
    }
    out = {"phase": "tiny_async_parity", "events": 4}
    for name, kw in cases.items():
        def build(device, mode="auto", kw=kw):
            args = dict(kw)
            if "strategy" in args:
                args["strategy"] = args["strategy"]()
            return tiny_mlp_sim(device, mode, **args)

        cpu = build("cpu")
        init = {k: v.clone() for k, v in cpu.global_params.items()}
        cpu.fit(4)
        card = {}
        for mode in (("pipelined",) if name == "registry" else ("pipelined", "auto")):
            sim = build("cuda", mode)
            sim.set_global_params(init)
            sim.fit(4)
            card[mode] = sim
            for gr, cr in zip(sim.history, cpu.history, strict=True):
                check(f"tiny async {name} {mode} fit loss r{gr.round}",
                      torch.tensor(gr.fit_losses["backward"]),
                      torch.tensor(cr.fit_losses["backward"]), 5e-4, 0)
                check(f"tiny async {name} {mode} eval loss r{gr.round}",
                      torch.tensor(gr.eval_losses["checkpoint"]),
                      torch.tensor(cr.eval_losses["checkpoint"]), 5e-4, 0)
            err = max(check(f"tiny async {name} {mode} param {k}", sim.global_params[k].cpu(),
                            cpu.global_params[k], 5e-4, 0) for k in init)
        routes_equal = None
        if len(card) == 2:
            routes_equal = (history_equal(*card.values())
                            and states_equal(*card.values()))
            if not routes_equal:
                fail(f"tiny async {name}: the card's chunked route differs from the pipelined")
        plan = card["pipelined"]._async_plan
        out[name] = {"fit_losses": [r.fit_losses["backward"] for r in cpu.history],
                     "max_param_abs_err": err, "routes_bit_equal": routes_equal,
                     "staleness_max": float(plan.staleness.max()),
                     "swapped": [m.get("swapped") for m in card["pipelined"].round_metrics]}
    if not any(out["registry"]["swapped"]):
        fail("tiny async registry: no seat changed occupant")
    print(json.dumps(out))
    return out


def async_dp_cifar_cnn(fa, dp) -> dict:
    """``async_dp_cifar_cnn``: the DP path (64 clients of 160 train and 64 val
    rows, batch 32, 5 DP-SGD steps at C 1, sigma 1, bf16, SGD(0.05)) under
    buffered async (buffer 32, jitter 0.05, clients 0 and 1 at 5x), 6
    events, cuDNN deterministic in this phase only: the "auto" route (which
    must be the chunked one) with the launch counts and the peak set to 0
    before, then the pipelined route; exactly 35 K1 and 280 K2 launches each
    (7 waves of 5 steps, all 64 clients under one vmap), none of K3-K5;
    histories and states equal bit for bit; the plan's staleness reaching 1;
    finite losses. Then buffer 64 without faults against the synchronous run
    over 2 rounds on both routes, bit for bit; the warm walls of 6 events on
    both routes and of 6 synchronous rounds (chunked), in turns; the virtual
    cadences."""
    from fl4health_tpu_torch.server import simulation as tsim
    from fl4health_tpu_torch.server.async_schedule import AsyncConfig, sync_round_times

    data = image_datasets(DP_CLIENTS, DP_TRAIN, DP_VAL, (32, 32, 3))
    cfg, faults = async_recipe()
    build = lambda mode, **kw: build_dp_sim(data, torch.bfloat16, "cuda", DP_SIGMA,  # noqa: E731
                                            seed=0, execution_mode=mode, **kw)
    expected = {"dp_sq_norms": (ASYNC_EVENTS + 1) * LOCAL_STEPS,
                "dp_scaled_sum": (ASYNC_EVENTS + 1) * LOCAL_STEPS * len(CIFAR_LEAVES),
                "flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    out = {"phase": "async_dp_cifar_cnn", "clients": DP_CLIENTS, "events": ASYNC_EVENTS,
           "buffer_size": ASYNC_BUFFER, "slow_clients": [0, 1], "slow_scale": ASYNC_SLOW,
           "cudnn_deterministic": True}
    try:
        sims = {m: build(m, async_config=cfg, fault_plan=faults) for m in ("auto", "pipelined")}
        mode = sims["auto"]._select_execution_mode(ASYNC_EVENTS)
        if mode[0] != tsim.EXEC_CHUNKED:
            fail(f"async_dp_cifar_cnn: execution_mode='auto' took {mode}")
        launches, cold = {}, {}
        for m, sim in sims.items():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            in_use = torch.cuda.memory_allocated()
            dp.reset_launch_counts()
            fa.reset_launch_counts()
            t0 = time.time()
            sim.fit(ASYNC_EVENTS)
            torch.cuda.synchronize()
            cold[m] = time.time() - t0
            launches[m] = {**dp.LAUNCHES, **fa.LAUNCHES}
            out[f"peak_mem_gib_{m}"] = torch.cuda.max_memory_allocated() / 2**30
            # above what was held before the run (the other sim's banks)
            out[f"peak_above_start_gib_{m}"] = (torch.cuda.max_memory_allocated()
                                                - in_use) / 2**30
            if launches[m] != expected:
                fail(f"async_dp_cifar_cnn {m}: launches {launches[m]}, expected {expected}")
            for r in sim.history:
                if not all(np.isfinite(v) for v in (*r.fit_losses.values(),
                                                      *r.eval_losses.values())):
                    fail(f"async_dp_cifar_cnn {m} event {r.round}: non-finite {r.fit_losses}")
        equal = history_equal(*sims.values()) and states_equal(*sims.values())
        if not equal:
            fail("async_dp_cifar_cnn: the chunked history or state differs from the pipelined")
        plan = sims["auto"]._async_plan
        stal = plan.staleness[plan.arrivals > 0]
        if stal.max() < 1:
            fail(f"async_dp_cifar_cnn: no stale update consumed (max {stal.max()})")
        # the degenerate plan: a buffer of the whole cohort, no stragglers
        degenerate = {}
        for m in ("pipelined", "auto"):  # the last, chunked, sync run is timed below
            sync = build(m)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            in_use = torch.cuda.memory_allocated()
            sync.fit(2)
            torch.cuda.synchronize()
            sync_peak = torch.cuda.max_memory_allocated() / 2**30
            sync_above = (torch.cuda.max_memory_allocated() - in_use) / 2**30
            asy = build(m, async_config=AsyncConfig(buffer_size=DP_CLIENTS))
            asy.fit(2)
            degenerate[m] = history_equal(sync, asy) and all(
                torch.equal(sync.global_params[k], asy.global_params[k])
                for k in sync.global_params)
            if not degenerate[m]:
                fail(f"async_dp_cifar_cnn: buffer 64 without faults differs from sync ({m})")
        # warm walls in turns: 6 events a route, 6 synchronous rounds
        runs = {"chunked": sims["auto"], "pipelined": sims["pipelined"], "sync": sync}
        walls = {k: [] for k in runs}
        for name in ("chunked", "pipelined", "sync", "sync", "pipelined", "chunked"):
            torch.cuda.synchronize()
            t0 = time.time()
            runs[name].fit(ASYNC_EVENTS)
            torch.cuda.synchronize()
            walls[name].append(time.time() - t0)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    out.update({
        "mode": list(mode), "launches": launches["auto"], "expected_launches": expected,
        "routes_bit_equal": equal, "degenerate_equals_sync": degenerate,
        # the synchronous chunked run's (2 rounds), its sim built before
        # the window, as the async runs' were
        "cold_s": cold, "peak_mem_gib_sync": sync_peak,
        "peak_above_start_gib_sync": sync_above,
        "warm_walls_s": walls,
        "s_per_event": {k: [w / ASYNC_EVENTS for w in v] for k, v in walls.items()},
        "fit_losses": [r.fit_losses["backward"] for r in sims["auto"].history[:ASYNC_EVENTS]],
        "eval_losses": [r.eval_losses["checkpoint"]
                        for r in sims["auto"].history[:ASYNC_EVENTS]],
        # bench.py's timed_async_block numbers on the virtual clock
        "staleness_mean": float(stal.mean()), "staleness_max": float(stal.max()),
        "sync_round_vs_clean": float(np.mean(sync_round_times(cfg, ASYNC_EVENTS, DP_CLIENTS))),
        "sync_round_vs_straggler": float(np.mean(sync_round_times(
            cfg, ASYNC_EVENTS, DP_CLIENTS, faults))),
        "async_cadence_vs": float(np.mean(plan.cadences()))})
    print(json.dumps(out))
    return out


def async_cohort_dp_cifar_cnn(fa, dp, source) -> dict:
    """``async_cohort_dp_cifar_cnn``: the DP path's model and client over
    the N 1,000 Dirichlet(0.5) registry, 64 seats under
    ``FullParticipationManager(1000)``, buffered async (buffer 32, jitter
    0.05, seats 0 and 1 at 5x): a cold event, then 4 events on the registry
    route with the launch counts and the peak set to 0 before: exactly 25
    K1 and 200 K2, none
    of K3-K5; the seats change occupants; finite losses; each event's swap,
    staging and scatter ms. Then 4 more events (a fresh plan) with every
    evicted occupant's stored row checked against its state when it left
    its seat, at each swap (untimed: the check pulls the rows again)."""
    from fl4health_tpu_torch.core.pytree import tree_leaves, tree_map
    from fl4health_tpu_torch.server import simulation as tsim
    from fl4health_tpu_torch.server.client_manager import FullParticipationManager
    from fl4health_tpu_torch.server.registry import CohortConfig

    n = COHORT_SIZES[0]
    cfg, faults = async_recipe()
    sim = build_dp_sim(source, torch.bfloat16, "cuda", DP_SIGMA, seed=0,
                       cohort=CohortConfig(slots=COHORT_SLOTS),
                       client_manager=FullParticipationManager(n), async_config=cfg,
                       fault_plan=faults)
    mode = sim._select_execution_mode(ASYNC_COHORT_EVENTS)
    if mode[0] != tsim.EXEC_PIPELINED:
        fail(f"async_cohort_dp_cifar_cnn: took {mode}")
    swap, checked = sim._swap_seats, []

    def checked_swap(changed, old_ids, new_ids):
        # the leaving occupants' rows as they stand before the swap
        idx = torch.as_tensor(changed, device="cuda")
        before = [x.cpu().numpy() for x in tree_leaves(
            tree_map(lambda t: t.index_select(0, idx), sim.client_states))]
        res = swap(changed, old_ids, new_ids)
        stored = tree_leaves(sim.registry.gather_client_states(np.asarray(old_ids)))
        checked.append(len(changed))
        if not all(np.array_equal(np.asarray(a), b) for a, b in zip(stored, before)):
            fail("async_cohort_dp_cifar_cnn: an evicted row differs from its seat's state")
        return res

    sim.fit(1)  # cold: a prologue and one event
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dp.reset_launch_counts()
    fa.reset_launch_counts()
    t0 = time.time()
    sim.fit(ASYNC_COHORT_EVENTS)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {**dp.LAUNCHES, **fa.LAUNCHES}
    peak = torch.cuda.max_memory_allocated() / 2**30
    facts = [{k: m[k] for k in ("swapped", "stage_ms", "gather_ms", "scatter_ms",
                                "staged_bytes", "staleness_max")}
             for m in sim.round_metrics[-ASYNC_COHORT_EVENTS:]]
    slot_ids = sim._async_plan.slot_ids
    sim._swap_seats = checked_swap
    sim.fit(ASYNC_COHORT_EVENTS)
    expected = {"dp_sq_norms": (ASYNC_COHORT_EVENTS + 1) * LOCAL_STEPS,
                "dp_scaled_sum": (ASYNC_COHORT_EVENTS + 1) * LOCAL_STEPS * len(CIFAR_LEAVES),
                "flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    if launches != expected:
        fail(f"async_cohort_dp_cifar_cnn: launches {launches}, expected {expected}")
    if not (slot_ids[1:] != slot_ids[:-1]).any() or not checked or sum(checked) == 0:
        fail("async_cohort_dp_cifar_cnn: no seat changed occupant")
    for r in sim.history:
        if not all(np.isfinite(v) for v in (*r.fit_losses.values(), *r.eval_losses.values())):
            fail(f"async_cohort_dp_cifar_cnn event {r.round}: non-finite {r.fit_losses}")
    out = {"phase": "async_cohort_dp_cifar_cnn", "registry_size": n, "slots": COHORT_SLOTS,
           "events": ASYNC_COHORT_EVENTS, "buffer_size": ASYNC_BUFFER, "mode": list(mode),
           "wall_s": wall, "s_per_event": wall / ASYNC_COHORT_EVENTS, "peak_mem_gib": peak,
           "launches": launches, "evicted_rows_checked": checked,
           "registry_dirty_rows": sim.registry.dirty_rows,
           "fit_losses": [r.fit_losses["backward"] for r in sim.history],
           "event_facts": facts, **host_rss_gib()}
    print(json.dumps(out))
    return out


# -- the checkpoint slice: crash-consistent state checkpointing and resume,
# the SIGKILL drill, and nnU-Net's sliding-window inference -----------------
CKPT_ROUNDS, CKPT_KILL = 4, 2  # dp_cifar_cnn saved after round 2 of 4
CKPT_ASYNC_EVERY = 3  # async frames after events 3 and 6 (of 6)
INFER_VOLUME, INFER_STEP = (256, 256, 192), 0.5  # 3 x 3 x 2 = 18 windows of 128^3


def ckpt_dir(tag: str) -> str:
    """A fresh checkpoint directory under the process's temp dir."""
    import tempfile

    return tempfile.mkdtemp(prefix=f"fl4h_{tag}_")


def drop_dirs(*dirs: str) -> None:
    import shutil

    for d in dirs:
        shutil.rmtree(d, ignore_errors=True)


def deterministic_flags() -> None:
    """The backend flags every bit-equality phase (and drill child) runs
    under: TF32 off, cuDNN deterministic."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True


def ckpt_dp_sim(data, mode: str, directory: str | None, every: int = 1, **sim_kw):
    """``dp_cifar_cnn`` (64 clients, batch 32, 5 DP-SGD steps, bf16) with a
    ``SimulationStateCheckpointer(keep=2, checkpoint_every=every)`` on
    ``directory`` (none for None)."""
    from fl4health_tpu_torch.checkpointing import SimulationStateCheckpointer

    if directory is not None:
        sim_kw["state_checkpointer"] = SimulationStateCheckpointer(
            directory, keep=2, checkpoint_every=every)
    return build_dp_sim(data, torch.bfloat16, "cuda", DP_SIGMA, seed=0, execution_mode=mode,
                        **sim_kw)


def counted_fit(sim, n: int, dp) -> dict:
    """``sim.fit(n)`` with the K1/K2 counts set to 0 before and read after."""
    dp.reset_launch_counts()
    sim.fit(n)
    torch.cuda.synchronize()
    return dict(dp.LAUNCHES)


def dp_launches(rounds: int) -> dict:
    return {"dp_sq_norms": rounds * LOCAL_STEPS,
            "dp_scaled_sum": rounds * LOCAL_STEPS * len(CIFAR_LEAVES)}


def save_stats(sim) -> list:
    return [{k: m["checkpoint"][k] for k in ("round", "generation", "bytes", "write_s")}
            for m in sim.round_metrics if "checkpoint" in m]


def ckpt_dp_cifar_cnn(dp) -> dict:
    """``ckpt_dp_cifar_cnn``, deterministic flags: on the chunked and the
    pipelined route, ``fit(2)`` saving every round, then a fresh simulation
    on the same directory ``fit(4)``: history, global params and client
    states bit-equal to a straight ``fit(4)``, and exactly the K1/K2
    launches of the rounds each arm ran (5 and 40 a round); a run saved
    pipelined and resumed chunked too. The frames' bytes and ``write_s``,
    a restore's ms, the state trees' pull as a second ``HostPull``, and the
    warm round with a save every round against no checkpointer, in turns,
    on both routes."""
    from fl4health_tpu_torch.server.pipeline import HostPull

    data = image_datasets(DP_CLIENTS, DP_TRAIN, DP_VAL, (32, 32, 3))
    out = {"phase": "ckpt_dp_cifar_cnn", "clients": DP_CLIENTS, "rounds": CKPT_ROUNDS,
           "resume_after": CKPT_KILL, "keep": 2, "checkpoint_every": 1}
    dirs = []
    straight = {}
    for route in ("chunked", "pipelined"):
        ref = ckpt_dp_sim(data, route, None)
        launches = {"straight": counted_fit(ref, CKPT_ROUNDS, dp)}
        straight[route] = ref
        d = ckpt_dir(route)
        dirs.append(d)
        first = ckpt_dp_sim(data, route, d)
        launches["saved"] = counted_fit(first, CKPT_KILL, dp)
        resumed = ckpt_dp_sim(data, route, d)
        launches["resumed"] = counted_fit(resumed, CKPT_ROUNDS, dp)
        want = {"straight": dp_launches(CKPT_ROUNDS), "saved": dp_launches(CKPT_KILL),
                "resumed": dp_launches(CKPT_ROUNDS - CKPT_KILL)}
        if launches != want:
            fail(f"ckpt_dp_cifar_cnn {route}: launches {launches}, expected {want}")
        equal = history_equal(ref, resumed) and states_equal(ref, resumed)
        if not equal or resumed._resume_info["next_round"] != CKPT_KILL + 1:
            fail(f"ckpt_dp_cifar_cnn {route}: the resumed run differs from the straight one "
                 f"(resume {resumed._resume_info})")
        stats = save_stats(first) + save_stats(resumed)
        # the state trees' pull as a pull of its own (on the routes it rides
        # the round's or the chunk's one pull)
        pulls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.time()
            pull = HostPull(resumed._snapshot_trees())
            pull.result()
            pulls.append({"wall_ms": (time.time() - t0) * 1e3, "device_ms": pull.device_ms,
                          "bytes": pull.nbytes})
        out[route] = {"bit_equal": equal, "launches": launches, "saves": stats,
                      "restore_s": resumed._resume_info["restore_s"],
                      "frame_bytes": stats[-1]["bytes"],
                      "snapshot_pull": pulls,
                      "fit_losses": [r.fit_losses["backward"] for r in resumed.history]}
        del first, resumed
    # saved pipelined, resumed chunked
    d = ckpt_dir("cross")
    dirs.append(d)
    ckpt_dp_sim(data, "pipelined", d).fit(CKPT_KILL)
    cross = ckpt_dp_sim(data, "chunked", d)
    cross.fit(CKPT_ROUNDS)
    torch.cuda.synchronize()
    out["pipelined_to_chunked_bit_equal"] = (history_equal(straight["chunked"], cross)
                                             and states_equal(straight["chunked"], cross))
    if not out["pipelined_to_chunked_bit_equal"]:
        fail("ckpt_dp_cifar_cnn: saved pipelined, resumed chunked differs from the straight run")
    del cross
    # warm rounds with a save every round against none, in turns
    walls = {}
    for route in ("chunked", "pipelined"):
        sim = straight[route]
        w = {"none_s": [], "every_round_s": []}
        for arm in ("none", "every_round", "every_round", "none"):
            if arm == "every_round":
                # an empty directory: nothing to restore, a frame each round
                from fl4health_tpu_torch.checkpointing import SimulationStateCheckpointer

                dirs.append(ckpt_dir("walls"))
                sim.state_checkpointer = SimulationStateCheckpointer(dirs[-1], keep=2)
            torch.cuda.synchronize()
            t0 = time.time()
            sim.fit(WARM_ROUNDS)
            torch.cuda.synchronize()
            w[f"{arm}_s"].append(time.time() - t0)
            sim.state_checkpointer = None
        walls[route] = {"rounds": WARM_ROUNDS, **w,
                        "s_per_round_none": min(w["none_s"]) / WARM_ROUNDS,
                        "s_per_round_every": min(w["every_round_s"]) / WARM_ROUNDS}
    out["warm_walls"] = walls
    drop_dirs(*dirs)
    print(card_line())
    print(json.dumps(out))
    return out


def drill_dp_cifar_cnn(ckpt_dir_: str | None, device: str = "cuda"):
    """The drill children's simulation (the crash drill loads this file and
    calls this factory): ``dp_cifar_cnn`` on the chunked route, a frame
    every round, under the deterministic flags."""
    deterministic_flags()
    data = image_datasets(DP_CLIENTS, DP_TRAIN, DP_VAL, (32, 32, 3))
    return ckpt_dp_sim(data, "chunked", ckpt_dir_)


def drill_spec(root: str, factory: str, tag: str, ckpt: str, kill=None) -> tuple:
    """One drill child's spec (a ``factory`` of this file at ``CKPT_ROUNDS``
    rounds, its ring in ``root/ckpt``) and the spec file's path."""
    return ({"factory_file": str(Path(__file__).resolve()), "factory_name": factory,
             "n_rounds": CKPT_ROUNDS, "ckpt_dir": os.path.join(root, ckpt),
             "out_dir": os.path.join(root, tag), "kill": kill, "device": "cuda"},
            os.path.join(root, f"{tag}.json"))


class DrillChildPool:
    """The drills' child processes, started before the checkpoint phases so
    that their start-up (the interpreter, torch and the port's imports, the
    CUDA context, cuBLAS and cuDNN, the DP extension's load) overlaps those
    phases instead of each drill wave. Each is a real process
    (``python3 chip_smoke.py --drill-child``) that waits for a spec path on
    stdin and then runs ``recovery.child_main``: the wave's kill points
    SIGKILL or SIGTERM it for real, and its exit status is the process's.
    ``close`` ends the children no wave took."""

    def __init__(self, n: int):
        import tempfile

        self.dir = tempfile.mkdtemp(prefix="fl4h_children_")
        self.free = []
        for i in range(n):
            logs = [open(os.path.join(self.dir, f"{i}.{kind}"), "w") for kind in ("out", "err")]
            proc = subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), "--drill-child"],
                stdin=subprocess.PIPE, stdout=logs[0], stderr=logs[1], text=True,
                cwd=str(Path(__file__).resolve().parent), start_new_session=True)
            for f in logs:
                f.close()
            self.free.append((proc, i))
        self.taken = []

    def wave(self, specs: dict, timeout_s: float = 600.0) -> tuple[dict, float]:
        """The children of ``specs`` (name -> (spec, spec path)) side by
        side, one warm process each; their results by name and the wave's
        wall."""
        from fl4health_tpu_torch.resilience.recovery import collect_child

        t0 = time.time()
        running = {}
        for name, (spec, path) in specs.items():
            with open(path, "w") as f:
                json.dump(spec, f)
            proc, i = self.free.pop(0)
            self.taken.append(proc)
            proc.stdin.write(path + "\n")
            proc.stdin.close()
            running[name] = (proc, i, spec)
        results = {}
        for name, (proc, i, spec) in running.items():
            try:
                code = proc.wait(timeout=max(1.0, timeout_s - (time.time() - t0)))
            except subprocess.TimeoutExpired:
                self.close()
                fail(f"drill child {name} did not end within {timeout_s} s")
            out, err = (Path(self.dir, f"{i}.{kind}").read_text() for kind in ("out", "err"))
            results[name] = collect_child(spec, code, out, err)
        return results, time.time() - t0

    def close(self) -> None:
        for proc, _ in self.free:
            proc.stdin.close()  # an empty spec line: the child exits
        for proc in [p for p, _ in self.free] + self.taken:
            try:
                proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                with contextlib.suppress(ProcessLookupError):
                    os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
        self.free, self.taken = [], []
        drop_dirs(self.dir)


def drill_child() -> int:
    """``python3 chip_smoke.py --drill-child``: start up as a drill child
    does (imports, the CUDA context, cuBLAS and cuDNN, the DP extension),
    then read one spec path from stdin and run ``recovery.child_main`` on
    it; exit at once on an empty line."""
    import fl4health_tpu_torch.checkpointing  # noqa: F401
    import fl4health_tpu_torch.clients.instance_level_dp  # noqa: F401
    import fl4health_tpu_torch.models.cnn  # noqa: F401
    import fl4health_tpu_torch.observability  # noqa: F401
    import fl4health_tpu_torch.server.simulation  # noqa: F401
    from fl4health_tpu_torch.kernels import dp_clip
    from fl4health_tpu_torch.resilience.recovery import child_main

    x = torch.ones((1, 1, 4, 4), device="cuda")
    F.conv2d(x, torch.ones((1, 1, 3, 3), device="cuda"))
    torch.ones((2, 2), device="cuda") @ torch.ones((2, 2), device="cuda")
    dp_clip.build_extension()
    torch.cuda.synchronize()
    path = sys.stdin.readline().strip()
    return child_main(path) if path else 0


def ckpt_drill_specs(root: str) -> tuple[dict, dict]:
    """``ckpt_drill``'s two waves: a straight child, a child SIGKILLed right
    after round 2's frame publishes and one SIGKILLed 4 KiB into round 3's
    frame write (its ring keeps rounds 1 and 2); then the killed child's
    resume and the torn ring's (whose newest generation is flipped between
    the waves)."""
    def spec(*a, **k):
        return drill_spec(root, "drill_dp_cifar_cnn", *a, **k)

    post = {"round": CKPT_KILL, "phase": "post_save"}
    torn = {"round": CKPT_KILL + 1, "phase": "mid_write", "byte_offset": 4096}
    return ({"straight": spec("straight", "straight_ckpt"),
             "killed": spec("killed", "drill_ckpt", post),
             "torn": spec("torn", "torn_ckpt", torn)},
            {"resumed": spec("resumed", "drill_ckpt"),
             "fallback": spec("fallback", "torn_ckpt")})


def ckpt_drill_check(res: dict, damaged: str, walls: list) -> dict:
    """``ckpt_drill``: dp_cifar_cnn at 4 rounds on the chunked route
    (``drill_dp_cifar_cnn``). The torn ring's newest generation was flipped
    (``corrupt_newest_generation(mode="flip")``), so its child resumes from
    round 1, ``fallback_skipped`` naming the damaged file, beside the
    killed child's resume from round 2. Both resumed children's final
    params' bytes and loss history equal the straight child's."""
    for name, code in (("straight", 0), ("killed", -signal.SIGKILL), ("resumed", 0),
                       ("torn", -signal.SIGKILL), ("fallback", 0)):
        if res[name].returncode != code:
            fail(f"ckpt_drill {name} child exited {res[name].returncode}, expected {code}: "
                 f"{res[name].stderr[-3000:]}")
    straight, resumed, fallback = res["straight"], res["resumed"], res["fallback"]
    if res["killed"].params_bytes is not None or res["torn"].params_bytes is not None:
        fail("ckpt_drill: a killed child finished")
    out = {"phase": "ckpt_drill", "rounds": CKPT_ROUNDS, "route": "chunked",
           "kill_round": CKPT_KILL, "wave_s": walls, "damaged": damaged,
           "resumed_from": resumed.done["resume"], "fallback_from": fallback.done["resume"]}
    for name, r in (("resumed", resumed), ("fallback", fallback)):
        same = r.params_bytes == straight.params_bytes and r.history == straight.history
        out[f"{name}_equal"] = same
        if not same or [h["round"] for h in r.history] != list(range(1, CKPT_ROUNDS + 1)):
            fail(f"ckpt_drill: the {name} child's params or history differ from the straight")
    if out["fallback_from"]["fallback_skipped"] != [damaged]:
        fail(f"ckpt_drill: fallback_skipped {out['fallback_from']['fallback_skipped']}, "
             f"expected [{damaged}]")
    if out["resumed_from"]["next_round"] != CKPT_KILL + 1:
        fail(f"ckpt_drill: resumed from {out['resumed_from']}")
    if out["fallback_from"]["next_round"] != CKPT_KILL:
        fail(f"ckpt_drill: the fallback resumed from {out['fallback_from']}")
    out["params_bytes"] = len(straight.params_bytes)
    out["history"] = straight.history
    print(json.dumps(out))
    return out


def drills(children: DrillChildPool) -> dict:
    """``ckpt_drill`` and ``obs_sigterm_drill``, their children in two
    waves side by side, each a warm process of ``children`` (each child is
    deterministic on the card whatever else runs): the first wave the five
    children that start fresh (3 + 2), the second the three resumes (2 +
    1). Between the waves the torn ring is flipped and the SIGTERM bundle
    read. Each drill's checks are its own; ``wave_s`` is both drills'
    walls."""
    from fl4health_tpu_torch.resilience.recovery import corrupt_newest_generation

    roots = {"ckpt": ckpt_dir("drill"), "obs": ckpt_dir("sigterm")}
    ckpt_first, ckpt_second = ckpt_drill_specs(roots["ckpt"])
    obs_first, obs_second = obs_sigterm_specs(roots["obs"])
    first, w1 = children.wave({**{("ckpt", k): v for k, v in ckpt_first.items()},
                            **{("obs", k): v for k, v in obs_first.items()}})
    ckpt_res = {k: v for (d, k), v in first.items() if d == "ckpt"}
    obs_res = {k: v for (d, k), v in first.items() if d == "obs"}
    torn = first[("ckpt", "torn")]
    if torn.returncode != -signal.SIGKILL:
        fail(f"ckpt_drill torn child exited {torn.returncode}: {torn.stderr[-3000:]}")
    damaged = corrupt_newest_generation(os.path.join(roots["ckpt"], "torn_ckpt"), mode="flip")
    verdict = obs_sigterm_bundle(obs_res, roots["obs"])
    second, w2 = children.wave({**{("ckpt", k): v for k, v in ckpt_second.items()},
                             **{("obs", k): v for k, v in obs_second.items()}})
    ckpt_res.update({k: v for (d, k), v in second.items() if d == "ckpt"})
    obs_res.update({k: v for (d, k), v in second.items() if d == "obs"})
    walls = [w1, w2]
    out = {"ckpt_drill": ckpt_drill_check(ckpt_res, damaged, walls),
           "obs_sigterm_drill": obs_sigterm_check(obs_res, verdict, roots["obs"], walls),
           "wave_s": walls, "children": [len(first), len(second)]}
    drop_dirs(*roots.values())
    return out


def ckpt_cohort_dp_cifar_cnn(dp, source) -> dict:
    """``ckpt_cohort_dp_cifar_cnn``, deterministic flags: the N 1,000
    registry of ``cohort_dp_cifar_cnn``, 64 slots, the compressed exchange
    with error feedback, the chunked cohort route: ``fit(2)`` saving every
    round, a fresh simulation ``fit(4)`` from its frame: history, slot
    states and every dirty registry row (client and error-feedback)
    bit-equal to a straight ``fit(4)``; 5 K1 and 40 K2 a round run; each
    frame's bytes (the dirty rows grow a round) and ``write_s``."""
    from fl4health_tpu_torch.checkpointing import SimulationStateCheckpointer
    from fl4health_tpu_torch.compression.config import CompressionConfig
    from fl4health_tpu_torch.server import simulation as tsim

    n = COHORT_SIZES[0]

    def build(directory=None):
        kw = ({"state_checkpointer": SimulationStateCheckpointer(directory, keep=2)}
              if directory else {})
        return build_cohort_sim(source, n, compression=CompressionConfig(**COMPRESSION), **kw)

    straight = build()
    launches = {"straight": counted_fit(straight, CKPT_ROUNDS, dp)}
    d = ckpt_dir("cohort")
    first = build(d)
    mode = first._select_execution_mode(CKPT_KILL)
    if mode[0] != tsim.EXEC_CHUNKED:
        fail(f"ckpt_cohort_dp_cifar_cnn: 'auto' took {mode}")
    launches["saved"] = counted_fit(first, CKPT_KILL, dp)
    resumed = build(d)
    t0 = time.time()
    launches["resumed"] = counted_fit(resumed, CKPT_ROUNDS, dp)
    resumed_s = time.time() - t0
    want = {"straight": dp_launches(CKPT_ROUNDS), "saved": dp_launches(CKPT_KILL),
            "resumed": dp_launches(CKPT_ROUNDS - CKPT_KILL)}
    if launches != want:
        fail(f"ckpt_cohort_dp_cifar_cnn: launches {launches}, expected {want}")
    equal = {"history": history_equal(straight, resumed),
             "states": states_equal(straight, resumed),
             "registry_rows": registry_rows_equal(straight.registry, resumed.registry)}
    if not all(equal.values()):
        fail(f"ckpt_cohort_dp_cifar_cnn: the resumed run differs: {equal}")
    if resumed.registry._strategy_store.dirty == 0:
        fail("ckpt_cohort_dp_cifar_cnn: no error-feedback rows were restored")
    out = {"phase": "ckpt_cohort_dp_cifar_cnn", "registry_size": n, "slots": COHORT_SLOTS,
           "compression": COMPRESSION, "mode": list(mode), "bit_equal": equal,
           "launches": launches, "saves": save_stats(first) + save_stats(resumed),
           "resumed_fit_s": resumed_s, "resume": resumed._resume_info,
           "dirty_rows": [resumed.registry.dirty_rows, resumed.registry._strategy_store.dirty]}
    drop_dirs(d)
    print(card_line())
    print(json.dumps(out))
    return out


def ckpt_async_dp_cifar_cnn(dp) -> dict:
    """``ckpt_async_dp_cifar_cnn``, deterministic flags: ``async_dp_cifar_cnn``'s
    recipe (buffer 32 of 64, clients 0 and 1 at 5x, 6 events), frames every
    3 events, on both dense async routes: ``fit(3)``, then a fresh
    simulation ``fit(6)`` resumed mid-plan after event 3 from the restored
    ``pending``: history and states bit-equal to a straight ``fit(6)``, the
    event-3 frame (server, clients, ``pending``) byte-equal to the straight
    run's own, and K1/K2 exact (the resumed arm runs no prologue). A changed
    ``AsyncConfig`` seed, bound to the frame's config hash, raises JAX's
    fingerprint message."""
    from fl4health_tpu_torch.checkpointing import SimulationStateCheckpointer, state
    from fl4health_tpu_torch.server.async_schedule import AsyncConfig

    data = image_datasets(DP_CLIENTS, DP_TRAIN, DP_VAL, (32, 32, 3))
    cfg, faults = async_recipe()
    k = CKPT_ASYNC_EVERY

    def build(mode, directory, config=cfg, **sc_kw):
        return ckpt_dp_sim(data, mode, None, async_config=config, fault_plan=faults,
                           state_checkpointer=SimulationStateCheckpointer(
                               directory, keep=2, checkpoint_every=k, **sc_kw))

    def blob_at(directory, event):
        for _g, path in state.StateCheckpointer(directory).candidate_paths():
            _h, meta, blob = state.read_frame(path)
            if meta["round"] == event:
                return blob
        fail(f"ckpt_async_dp_cifar_cnn: no frame of event {event} in {directory}")

    out = {"phase": "ckpt_async_dp_cifar_cnn", "events": ASYNC_EVENTS, "resume_after": k,
           "buffer_size": ASYNC_BUFFER, "checkpoint_every": k}
    dirs = []
    for route in ("chunked", "pipelined"):
        ds, dr = ckpt_dir("async_s"), ckpt_dir("async_r")
        dirs += [ds, dr]
        straight = build(route, ds)
        launches = {"straight": counted_fit(straight, ASYNC_EVENTS, dp)}
        # the straight run's event-3 frame, before its event-6 save prunes
        # nothing (keep 2): both stay
        first = build(route, dr)
        launches["saved"] = counted_fit(first, k, dp)
        resumed = build(route, dr)
        launches["resumed"] = counted_fit(resumed, ASYNC_EVENTS, dp)
        want = {"straight": dp_launches(ASYNC_EVENTS + 1), "saved": dp_launches(k + 1),
                "resumed": dp_launches(ASYNC_EVENTS - k)}
        if launches != want:
            fail(f"ckpt_async_dp_cifar_cnn {route}: launches {launches}, expected {want}")
        pending_equal = blob_at(dr, k) == blob_at(ds, k)
        equal = history_equal(straight, resumed) and states_equal(straight, resumed)
        if not (equal and pending_equal):
            fail(f"ckpt_async_dp_cifar_cnn {route}: resumed differs (states/history {equal}, "
                 f"event-{k} frame {pending_equal})")
        out[route] = {"bit_equal": equal, "frame_equal": pending_equal, "launches": launches,
                      "saves": save_stats(first) + save_stats(resumed),
                      "resume": resumed._resume_info}
        if route == "chunked":
            other = build(route, dr, AsyncConfig(buffer_size=ASYNC_BUFFER, compute_jitter=0.05,
                                                 seed=cfg.seed + 1),
                          config_hash=first.state_checkpointer.config_hash)
            try:
                other.fit(ASYNC_EVENTS)
            except ValueError as e:
                msg = str(e)
            else:
                fail("ckpt_async_dp_cifar_cnn: a changed AsyncConfig seed resumed")
            want_msg = ("was written under a different async event plan (fingerprint "
                        "mismatch over the first 6 events) — the AsyncConfig seed, FaultPlan, "
                        "cohort and buffer_size must match the interrupted run for the "
                        "buffered updates to resume bit-identically")
            if want_msg not in msg:
                fail(f"ckpt_async_dp_cifar_cnn: the seed change raised {msg!r}")
            out["seed_change_refused"] = msg
        del straight, first, resumed
    drop_dirs(*dirs)
    print(json.dumps(out))
    return out


def nnunet_inference(nnunet_sim) -> dict:
    """``nnunet_inference``: sliding-window inference with config 5's
    network (plans from ``generate_plans``' default at a 128^3 patch, 6
    stages, 31,195,594 params) and ``nnunet_fullres``'s global params after
    its rounds, TF32 off and cuDNN deterministic for the checks: a volume
    equal to the patch, uniform weights, equals the direct forward (1e-5);
    a 256x256x192x1
    synthetic volume at step 0.5 with the Gaussian map (18 windows) equals
    a float64 numpy blend of the card's own per-window outputs (1e-5); a
    tiny 3-D U-Net's inference on the card within 5e-4 of the CPU's. Then
    the ms a volume (TF32 off, and on as PyTorch's default has it),
    voxels/s and the peak memory."""
    import itertools

    from fl4health_tpu_torch.clients import engine
    from fl4health_tpu_torch.models.unet import PlainConvUNet
    from fl4health_tpu_torch.nnunet.inference import (_window_starts, gaussian_importance_map,
                                                      sliding_window_predict)

    model, params = nnunet_sim.logic.model, nnunet_sim.global_params
    n_params = sum(v.numel() for v in params.values())
    patch = (NNU_SIZE,) * 3
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.backends.cudnn.deterministic)
    out = {"phase": "nnunet_inference", "n_params": n_params, "patch": list(patch),
           "volume": list(INFER_VOLUME), "step_fraction": INFER_STEP}
    try:
        deterministic_flags()
        g = torch.Generator(device="cuda").manual_seed(7)
        one = torch.randn((*patch, 1), generator=g, device="cuda")
        direct = model.apply(params, {}, one[None], train=False)[0][0]["prediction"][0].float()
        # with uniform weights: the Gaussian map falls below the 1e-8 floor
        # of JAX's division near a 128^3 patch's corners, where a lone
        # window's logits come out scaled down (in JAX as here)
        slid = sliding_window_predict(model.apply, params, None, one, patch, gaussian=False)
        out["patch_equals_volume_err"] = check("inference patch == volume", slid, direct,
                                               1e-5, 0)
        out["gaussian_below_floor_voxels"] = int((gaussian_importance_map(patch)
                                                  < 1e-8).sum())
        vol = torch.randn((*INFER_VOLUME, 1), generator=g, device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        got = sliding_window_predict(model.apply, params, None, vol, patch, INFER_STEP)
        torch.cuda.synchronize()
        out["first_call_ms"] = (time.time() - t0) * 1e3
        out["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
        starts = [_window_starts(s, p, INFER_STEP) for s, p in zip(INFER_VOLUME, patch)]
        corners = list(itertools.product(*starts))
        out["windows"] = len(corners)
        weight = gaussian_importance_map(patch).astype(np.float64)[..., None]
        logits = norm = None
        with torch.inference_mode():
            for c in corners:
                w = tuple(slice(s, s + p) for s, p in zip(c, patch))
                pred = model.apply(params, {}, vol[w][None], train=False)[0][0]["prediction"][0]
                pred = pred.float().cpu().numpy().astype(np.float64)
                if logits is None:
                    logits = np.zeros((*INFER_VOLUME, pred.shape[-1]))
                    norm = np.zeros((*INFER_VOLUME, 1))
                logits[w] += pred * weight
                norm[w] += weight
        want = torch.from_numpy(logits / np.maximum(norm, 1e-8))
        out["blend_max_abs_err"] = check("inference 18-window blend vs float64", got.cpu().double(),
                                         want, 1e-5, 0)
        if out["windows"] != 18 or tuple(got.shape) != (*INFER_VOLUME, 2):
            fail(f"nnunet_inference: {out['windows']} windows, output {tuple(got.shape)}")
        if not bool(torch.isfinite(got).all()):
            fail("nnunet_inference: non-finite logits")
        del logits, norm, want
        # a tiny 3-D U-Net, card against CPU
        net = PlainConvUNet(1, (4, 8), ((1, 1, 1), (2, 2, 2)), ((3, 3, 3), (3, 3, 3)), 3,
                            n_conv_per_stage=1, deep_supervision=False)
        tiny = engine.from_module(net)
        tp = net.init_params(torch.Generator().manual_seed(1))
        x = torch.tensor(np.random.default_rng(2).standard_normal((20, 18, 16, 1)).astype(
            np.float32))
        tiny_card = sliding_window_predict(tiny.apply, {k: v.cuda() for k, v in tp.items()},
                                           None, x.cuda(), (12, 12, 12))
        tiny_cpu = sliding_window_predict(tiny.apply, tp, None, x, (12, 12, 12))
        out["tiny_card_vs_cpu_err"] = check("tiny inference card vs CPU", tiny_card.cpu(),
                                            tiny_cpu, 5e-4, 0)
        # timing: 2 volumes at each TF32 setting
        for tf32 in (False, True):
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
            torch.backends.cudnn.deterministic = False
            ms = []
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.time()
                sliding_window_predict(model.apply, params, None, vol, patch, INFER_STEP)
                torch.cuda.synchronize()
                ms.append((time.time() - t0) * 1e3)
            key = "tf32_on" if tf32 else "tf32_off"
            out[f"ms_per_volume_{key}"] = ms
            out[f"voxels_per_s_{key}"] = math.prod(INFER_VOLUME) / (min(ms) / 1e3)
    finally:
        (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.deterministic) = flags
    print(card_line())
    print(json.dumps(out))
    return out


def ckpt_card_to_cpu() -> dict:
    """A frame saved by a card run of the tiny Mlp recipe resumes in a CPU
    simulation, which goes on within 5e-4 of the CPU's straight run from the
    same params."""
    from fl4health_tpu_torch.checkpointing import SimulationStateCheckpointer

    d = ckpt_dir("card_to_cpu")
    card = tiny_mlp_sim("cuda", state_checkpointer=SimulationStateCheckpointer(d))
    init = {k: v.cpu() for k, v in card.global_params.items()}
    card.fit(2)
    cpu = tiny_mlp_sim("cpu", state_checkpointer=SimulationStateCheckpointer(d))
    cpu.fit(4)
    ref = tiny_mlp_sim("cpu")
    ref.set_global_params(init)
    ref.fit(4)
    if cpu._resume_info is None or cpu._resume_info["next_round"] != 3:
        fail(f"ckpt_card_to_cpu: the CPU run resumed from {cpu._resume_info}")
    errs = []
    for a, b in zip(cpu.history, ref.history, strict=True):
        errs.append(check(f"card-to-CPU resume fit loss r{a.round}",
                          torch.tensor(a.fit_losses["backward"]),
                          torch.tensor(b.fit_losses["backward"]), 5e-4, 0))
    err = max(check(f"card-to-CPU resume param {k}", cpu.global_params[k],
                    ref.global_params[k], 5e-4, 0) for k in ref.global_params)
    drop_dirs(d)
    out = {"phase": "ckpt_card_to_cpu", "rounds": 4, "saved_on": "cuda", "resumed_on": "cpu",
           "max_loss_abs_err": max(errs), "max_param_abs_err": err}
    print(json.dumps(out))
    return out



# -- the observability slice --------------------------------------------------

OBS_ROUNDS = 2
OBS_POISONED = DP_CLIENTS - 1  # the halt phase's NaN client


def obs_handle(**kw):
    """An enabled observability handle with a private registry and tracer
    (introspection off: phase 35 drives it)."""
    from fl4health_tpu_torch.observability import MetricsRegistry, Observability, Tracer

    return Observability(enabled=True, registry=MetricsRegistry(), tracer=Tracer(),
                         introspection=False, **kw)


def scrape(url: str) -> tuple[int, str]:
    """One GET with a short timeout: (status, body)."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


class ScrapeAtRound:
    """A reporter that scrapes the live endpoint when round ``rnd``'s report
    arrives (its metrics are recorded before the reports)."""

    def __init__(self, obs, rnd: int):
        self.obs, self.rnd, self.seen = obs, rnd, {}

    def report(self, payload, round=None):  # noqa: A002 (the reporters' API)
        if round == self.rnd:
            base = self.obs.scrape_url
            self.seen = {"metrics": scrape(base + "/metrics"),
                         "healthz": scrape(base + "/healthz")}

    def shutdown(self):
        pass


def jsonl_events(directory: str) -> list:
    with open(os.path.join(directory, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def trajectory_equal(a, b) -> bool:
    """Two runs' losses, metrics and states bit for bit (the fit losses'
    ``backward``: a telemetry build also averages DP's clip fraction)."""
    return ([r.round for r in a.history] == [r.round for r in b.history]
            and all(x.fit_losses["backward"] == y.fit_losses["backward"]
                    and x.fit_metrics == y.fit_metrics and x.eval_losses == y.eval_losses
                    and x.eval_metrics == y.eval_metrics
                    for x, y in zip(a.history, b.history))
            and states_equal(a, b))


def obs_dp_cifar_cnn(dp) -> dict:
    """``obs_dp_cifar_cnn``, deterministic flags: ``dp_cifar_cnn`` at full
    width for 2 rounds on the chunked and on the pipelined route, with
    observability on (an output dir, a ``HealthWatchdog(HealthPolicy())``,
    the scrape endpoint on port 0) against the same-seed run with it off:
    the histories and the states bit-equal, the two routes' telemetry
    bit-equal, the clip fraction in [0, 1], the K1/K2 launches the off
    run's; ``/metrics`` shows ``fl_rounds_total 2`` and ``/healthz`` 200 at
    round 2's report. Readings: the JSONL event names, the warm round's wall
    with observability on and off in turns, the ring's and the ledger's
    bytes."""
    from fl4health_tpu_torch.observability import HealthPolicy, HealthWatchdog

    data = image_datasets(DP_CLIENTS, DP_TRAIN, DP_VAL, (32, 32, 3))
    out = {"phase": "obs_dp_cifar_cnn", "clients": DP_CLIENTS, "rounds": OBS_ROUNDS}
    telemetry, dirs = {}, []
    for route in ("chunked", "pipelined"):
        off = build_dp_sim(data, torch.bfloat16, "cuda", DP_SIGMA, seed=0,
                           execution_mode=route)
        launches = {"off": counted_fit(off, OBS_ROUNDS, dp)}
        d = ckpt_dir(f"obs_{route}")
        dirs.append(d)
        obs = obs_handle(output_dir=d, watchdog=HealthWatchdog(HealthPolicy()), http_port=0)
        probe = ScrapeAtRound(obs, OBS_ROUNDS)
        on = build_dp_sim(data, torch.bfloat16, "cuda", DP_SIGMA, seed=0,
                          execution_mode=route, observability=obs, reporters=[probe])
        launches["on"] = counted_fit(on, OBS_ROUNDS, dp)
        if launches["on"] != launches["off"] or launches["on"] != dp_launches(OBS_ROUNDS):
            fail(f"obs_dp_cifar_cnn {route}: launches {launches}, expected "
                 f"{dp_launches(OBS_ROUNDS)} on and off")
        if not trajectory_equal(off, on):
            fail(f"obs_dp_cifar_cnn {route}: observability on is not bit-equal to off")
        events = jsonl_events(d)
        tel = [{k: v for k, v in e.items() if k != "ts"} for e in events
               if e["event"] == "telemetry"]
        telemetry[route] = tel
        clip = np.asarray([e["clip_fraction"] for e in tel], np.float64)
        if len(tel) != OBS_ROUNDS or not np.all((clip >= 0) & (clip <= 1)):
            fail(f"obs_dp_cifar_cnn {route}: telemetry {len(tel)} rounds, clip {clip}")
        metrics, healthz = probe.seen.get("metrics"), probe.seen.get("healthz")
        if (metrics is None or metrics[0] != 200
                or "fl_rounds_total 2" not in metrics[1].splitlines()
                or healthz != (200, "ok\n")):
            fail(f"obs_dp_cifar_cnn {route}: live endpoint {metrics and metrics[0]}, "
                 f"/healthz {healthz}")
        # warm rounds, observability off and on in turns
        w = {"off_s": [], "on_s": []}
        for arm in ("off", "on", "on", "off"):
            sim = on if arm == "on" else off
            torch.cuda.synchronize()
            t0 = time.time()
            sim.fit(WARM_ROUNDS)
            torch.cuda.synchronize()
            w[f"{arm}_s"].append(time.time() - t0)
        out[route] = {
            "bit_equal": True, "launches": launches,
            "event_names": sorted({e["event"] for e in events}),
            "round_event_keys": sorted(next(e for e in events if e["event"] == "round")),
            "clip_fraction_mean": [float(np.mean(e["clip_fraction"])) for e in tel],
            "grad_norm_max": [float(np.max(e["grad_norm_max"])) for e in tel],
            "warm_walls": {"rounds": WARM_ROUNDS, **w,
                           "s_per_round_off": min(w["off_s"]) / WARM_ROUNDS,
                           "s_per_round_on": min(w["on_s"]) / WARM_ROUNDS},
            "ring_bytes": obs.flight_recorder.nbytes(),
            "ledger_bytes": obs.fleet_ledger.nbytes(),
            "metrics_healthz": [metrics[0], healthz[0]]}
        del off, on
    if telemetry["chunked"] != telemetry["pipelined"]:
        fail("obs_dp_cifar_cnn: the chunked and pipelined routes' telemetry differ")
    out["routes_telemetry_bit_equal"] = True
    drop_dirs(*dirs)
    print(card_line())
    print(json.dumps(out))
    return out


def obs_halt_bundle(dp) -> dict:
    """``obs_halt_bundle``: the same full-width run on both routes with
    client 63's training features NaN and the watchdog halting on
    non-finite values: ``fit`` raises ``TrainingHealthError`` naming round 1
    and client 63, one bundle is published and ``load_bundle`` reads it back
    (the ring frame's CRC intact) with verdict ``training_health``, and the
    live ``/healthz`` answers 503 once the run is marked unhealthy."""
    from fl4health_tpu_torch.observability import (HealthPolicy, HealthWatchdog,
                                                   TrainingHealthError)
    from fl4health_tpu_torch.observability.bundle import list_bundles, load_bundle
    from fl4health_tpu_torch.server.simulation import ClientDataset

    data = image_datasets(DP_CLIENTS, DP_TRAIN, DP_VAL, (32, 32, 3))
    bad = data[OBS_POISONED]
    data[OBS_POISONED] = ClientDataset(torch.full_like(bad.x_train, float("nan")),
                                       bad.y_train, bad.x_val, bad.y_val)
    out = {"phase": "obs_halt_bundle", "clients": DP_CLIENTS, "poisoned": OBS_POISONED}
    for route in ("chunked", "pipelined"):
        d = ckpt_dir(f"halt_{route}")
        obs = obs_handle(output_dir=d, http_port=0,
                         watchdog=HealthWatchdog(HealthPolicy(on_nonfinite="halt")))
        probes = []
        mark = obs.mark_unhealthy

        def mark_and_probe(reason, obs=obs, mark=mark, probes=probes):
            mark(reason)  # then the live endpoint, before fit() tears it down
            probes.append(scrape(obs.scrape_url + "/healthz")[0])

        obs.mark_unhealthy = mark_and_probe
        sim = build_dp_sim(data, torch.bfloat16, "cuda", DP_SIGMA, seed=0,
                           execution_mode=route, observability=obs)
        dp.reset_launch_counts()
        try:
            sim.fit(OBS_ROUNDS)
            fail(f"obs_halt_bundle {route}: fit did not halt")
        except TrainingHealthError as e:
            err = e
        torch.cuda.synchronize()
        if (err.round, err.clients, err.check) != (1, [OBS_POISONED], "nonfinite"):
            fail(f"obs_halt_bundle {route}: halted at round {err.round}, clients "
                 f"{err.clients}, check {err.check}")
        bundles = list_bundles(d)
        if len(bundles) != 1:
            fail(f"obs_halt_bundle {route}: {len(bundles)} bundles published")
        b = load_bundle(bundles[0])  # CRC-verifies the ring frame
        v = b["verdict"]
        if (v["kind"], v["round"], v["clients"]) != ("training_health", 1, [OBS_POISONED]):
            fail(f"obs_halt_bundle {route}: verdict {v}")
        if not probes or probes[0] != 503:
            fail(f"obs_halt_bundle {route}: /healthz answered {probes}")
        out[route] = {"verdict": {k: v[k] for k in ("kind", "round", "clients", "check")},
                      "ring_rounds": b["ring_header"]["rounds"],
                      "bundle_files": sorted(os.listdir(bundles[0])),
                      "healthz": probes, "launches": dict(dp.LAUNCHES)}
        drop_dirs(d)
        del sim
    print(json.dumps(out))
    return out


def obs_cohort_dp_cifar_cnn(dp, sources) -> dict:
    """``obs_cohort_dp_cifar_cnn``: the cohort route at N 1,000 and N 100,000
    (the registries of ``cohort_dp_cifar_cnn``), 64 slots, 2 rounds chunked,
    observability on: the ledger's records keyed by registry ids, the ring's
    bytes equal at both N, 5 K1 and 40 K2 launches a round."""
    from fl4health_tpu_torch.server import simulation as tsim

    out = {"phase": "obs_cohort_dp_cifar_cnn", "slots": COHORT_SLOTS, "rounds": OBS_ROUNDS}
    for n in COHORT_SIZES:
        obs = obs_handle()
        sim = build_cohort_sim(sources[n], n, observability=obs)
        mode = sim._select_execution_mode(OBS_ROUNDS)
        if mode[0] != tsim.EXEC_CHUNKED:
            fail(f"obs_cohort N={n}: 'auto' took {mode}")
        launches = counted_fit(sim, OBS_ROUNDS, dp)
        if launches != dp_launches(OBS_ROUNDS):
            fail(f"obs_cohort N={n}: launches {launches}, expected {dp_launches(OBS_ROUNDS)}")
        ledger = obs.fleet_ledger
        ids = sorted(int(c["client_id"]) for c in ledger.snapshot()["clients"])
        ring_ids = [np.asarray(e["registry_ids"]) for e in obs.flight_recorder.entries]
        if (len(ids) > OBS_ROUNDS * COHORT_SLOTS or max(ids) >= n
                or max(ids) < COHORT_SLOTS or not all(set(r.tolist()) <= set(ids)
                                                      for r in ring_ids)):
            fail(f"obs_cohort N={n}: ledger ids {ids[:8]}... (max {max(ids)})")
        out[f"n_{n}"] = {"registry_size": n, "mode": list(mode), "launches": launches,
                         "clients_seen": len(ledger), "max_id": max(ids),
                         "ring_bytes": obs.flight_recorder.nbytes(),
                         "ledger_bytes": ledger.nbytes()}
        del sim
        torch.cuda.empty_cache()
    small, large = (out[f"n_{n}"] for n in COHORT_SIZES)
    if small["ring_bytes"] != large["ring_bytes"]:
        fail(f"obs_cohort: ring bytes {small['ring_bytes']} at N {COHORT_SIZES[0]}, "
             f"{large['ring_bytes']} at N {COHORT_SIZES[-1]}")
    print(json.dumps(out))
    return out


def drill_obs_dp_cifar_cnn(ckpt_dir_: str | None, device: str = "cuda"):
    """The SIGTERM drill's children: ``drill_dp_cifar_cnn`` with
    observability on (the flight recorder and the fleet ledger armed), its
    artifacts and bundles beside the checkpoint directory (``<dir>_obs``)."""
    deterministic_flags()
    data = image_datasets(DP_CLIENTS, DP_TRAIN, DP_VAL, (32, 32, 3))
    return ckpt_dp_sim(data, "chunked", ckpt_dir_,
                       observability=obs_handle(output_dir=f"{ckpt_dir_}_obs"))


def obs_sigterm_specs(root: str) -> tuple[dict, dict]:
    """``obs_sigterm_drill``'s two waves: an unkilled child and one sent
    SIGTERM right after round 2's frame; then the killed child's resume."""
    def spec(*a, **k):
        return drill_spec(root, "drill_obs_dp_cifar_cnn", *a, **k)

    return ({"straight": spec("straight", "straight_ckpt"),
             "killed": spec("killed", "drill_ckpt",
                            {"round": CKPT_KILL, "signal_name": "SIGTERM"})},
            {"resumed": spec("resumed", "drill_ckpt")})


def obs_sigterm_bundle(res: dict, root: str) -> dict:
    """After the first wave: the killed child exited 143 with one
    ``sigterm`` bundle naming the round the signal arrived at and round 2's
    generation to resume from."""
    from fl4health_tpu_torch.observability.bundle import list_bundles, load_bundle

    straight, killed = res["straight"], res["killed"]
    if straight.returncode != 0 or killed.returncode != 143:
        fail(f"obs_sigterm_drill: straight exited {straight.returncode}, killed "
             f"{killed.returncode} (expected 143): {killed.stderr[-3000:]}")
    bundles = list_bundles(os.path.join(root, "drill_ckpt_obs"))
    if len(bundles) != 1:
        fail(f"obs_sigterm_drill: {len(bundles)} bundles")
    v = load_bundle(bundles[0])["verdict"]
    if (v["kind"] != "sigterm" or not CKPT_KILL <= v.get("round", 0) <= CKPT_ROUNDS
            or v.get("resume", {}).get("round") != CKPT_KILL):
        fail(f"obs_sigterm_drill: verdict {v}")
    return v


def obs_sigterm_check(res: dict, v: dict, root: str, walls: list) -> dict:
    """``obs_sigterm_drill``: ``ckpt_drill``'s drill with observability on
    and the SIGTERM kill point; the resumed child starts at round 3, adopts
    the frame's fleet ledger (no client is new in rounds 3-4) and ends
    bit-equal (final params' bytes, loss history) to the unkilled child."""
    straight, killed, resumed = res["straight"], res["killed"], res["resumed"]
    if resumed.returncode != 0:
        fail(f"obs_sigterm_drill: resumed child exited {resumed.returncode}: "
             f"{resumed.stderr[-3000:]}")
    rounds = [e for e in jsonl_events(os.path.join(root, "drill_ckpt_obs"))
              if e["event"] == "round"]
    new = [(e["round"], e["participants_new"]) for e in rounds]
    same = (resumed.params_bytes == straight.params_bytes
            and resumed.history == straight.history)
    if (not same or resumed.done["resume"]["next_round"] != CKPT_KILL + 1
            or new != [(r, 0) for r in range(CKPT_KILL + 1, CKPT_ROUNDS + 1)]):
        fail(f"obs_sigterm_drill: resumed equal={same}, resume {resumed.done['resume']}, "
             f"new participants {new}")
    out = {"phase": "obs_sigterm_drill", "rounds": CKPT_ROUNDS, "route": "chunked",
           "kill_round": CKPT_KILL, "killed_exit": killed.returncode,
           "verdict": {k: v.get(k) for k in ("kind", "round", "signal", "resume")},
           "resumed_from": resumed.done["resume"], "resumed_equal": same,
           "new_participants_after_resume": new, "wave_s": walls}
    print(json.dumps(out))
    return out


# -- the recovery slice ---------------------------------------------------------

# the unsupervised arm halts at round 4 and the supervised one replays from
# round 3, so 5 rounds run one round past the recovery
RECOVERY_ROUNDS = 5
# the clients of the scale fault (-15, probability 1, from round 2): every
# fourth of the 64. On 4 clients the fault cannot diverge: their weights
# (4 x -15) cancel the 60 honest ones in the weighted mean, so it stalls
# the run (on the card, 8 rounds: fit loss 2.33 to 2.35, never 1.01x its
# best; 16 clients: 3.93 at round 4, 1.69x)
RECOVERY_FAULTED = tuple(range(0, 64, 4))
# the reference drill's watchdog: a loss divergence over a window of 1 round
# at factor 1.4 (raised in steps of 0.2 if the fault-free arm trips it)
RECOVERY_FACTOR = 1.4
TINY_RECOVERY_ROUNDS = 10  # the reference drill's


def recovery_obs(directory: str, factor: float = RECOVERY_FACTOR, watchdog: bool = True):
    """An enabled handle with its output dir and the drill's watchdog (halt
    on a loss divergence over 1 round at ``factor``, or on non-finite
    values)."""
    from fl4health_tpu_torch.observability import HealthPolicy, HealthWatchdog

    return obs_handle(output_dir=directory, sync_device=False, watchdog=HealthWatchdog(
        HealthPolicy(loss_divergence_window=1, loss_divergence_factor=factor,
                     on_loss_divergence="halt", on_nonfinite="halt")) if watchdog else None)


def scale_fault_plan(clients: tuple):
    from fl4health_tpu_torch.resilience import ClientFault, FaultPlan

    return FaultPlan(seed=3, client_faults=(ClientFault(
        clients=clients, kind="scale", scale=-15.0, probability=1.0, start_round=2),))


def recovery_trail(obs_dir: str) -> tuple[list, list]:
    """(the bundles' verdicts, the recovery and quarantine events): each
    attempt's bundle keeps its event tail, the last run's JSONL the rest."""
    from fl4health_tpu_torch.observability.bundle import list_bundles, load_bundle

    verdicts, events = [], []
    for path in list_bundles(obs_dir):
        b = load_bundle(path)
        verdicts.append({k: b["verdict"].get(k) for k in ("kind", "round", "check", "clients")})
        events.extend(b["events"])
    if os.path.exists(os.path.join(obs_dir, "metrics.jsonl")):
        events.extend(jsonl_events(obs_dir))
    keep = [{k: v for k, v in e.items() if k != "ts"} for e in events
            if e.get("event") in ("recovery", "quarantine")]
    return verdicts, keep


def ledger_doc(sup) -> dict:
    doc = sup._ledger_doc()
    if doc.get("last_verdict"):
        doc["last_verdict"] = {k: v for k, v in doc["last_verdict"].items() if k != "ts"}
    return doc


def tiny_recovery_drill(device: str, root: str) -> dict:
    """The reference drill (tests/resilience/test_supervisor.py, the recipe
    of tests/torch_resilience_sims.py) on ``device``: an Mlp of 6 features, 8
    hidden units and 3 classes over 6 clients (``synthetic_classification``
    at keys 20..25, 24 train and 8 val rows), SGD 0.05, batch 8, 2 local
    steps, seed 9, FedAvg, the scale fault on clients 1 and 2 from round 2,
    the watchdog, a frame every round, ``RecoveryPolicy(probation_rounds=3,
    quarantine_rounds=0)``, 10 rounds on the chunked route."""
    from fl4health_tpu_torch import optim, rng
    from fl4health_tpu_torch.checkpointing import SimulationStateCheckpointer
    from fl4health_tpu_torch.clients import engine
    from fl4health_tpu_torch.datasets.synthetic import synthetic_classification
    from fl4health_tpu_torch.metrics import efficient
    from fl4health_tpu_torch.metrics.base import MetricManager
    from fl4health_tpu_torch.models.cnn import Mlp
    from fl4health_tpu_torch.resilience import RecoveryPolicy
    from fl4health_tpu_torch.server.simulation import ClientDataset, FederatedSimulation
    from fl4health_tpu_torch.strategies.fedavg import FedAvg

    data = []
    for i in range(6):
        x, y = synthetic_classification(rng.PRNGKey(20 + i, "cpu"), 32, (6,), 3)
        data.append(ClientDataset(x[:24], y[:24], x[24:], y[24:]))
    obs_dir = os.path.join(root, f"{device}_obs")
    sim = FederatedSimulation(
        logic=engine.ClientLogic(engine.from_module(Mlp(6, (8,), 3)),
                                 engine.masked_cross_entropy),
        tx=optim.sgd(0.05), strategy=FedAvg(), datasets=data, batch_size=8,
        metrics=MetricManager((efficient.accuracy(),)), local_steps=2, seed=9,
        execution_mode="chunked", observability=recovery_obs(obs_dir),
        fault_plan=scale_fault_plan((1, 2)),
        state_checkpointer=SimulationStateCheckpointer(os.path.join(root, f"{device}_ck"),
                                                       checkpoint_every=1, keep=8),
        recovery=RecoveryPolicy(probation_rounds=3, quarantine_rounds=0), device=device)
    hist = sim.fit(TINY_RECOVERY_ROUNDS)
    verdicts, events = recovery_trail(obs_dir)
    engages = [e for e in events if e.get("phase") == "engage"]
    sup = sim._recovery_supervisor
    return {"rounds": [r.round for r in hist], "verdicts": verdicts,
            "rungs": [e["rung"] for e in engages],
            "suspects": [e["suspects"] for e in engages],
            "rollback": [e["rollback"] for e in engages],
            "resume_rounds": [e["resume_round"] for e in engages],
            "roster": sorted(sup._quarantine), "ledger": ledger_doc(sup),
            "fit_losses": [r.fit_losses["backward"] for r in hist],
            "params": {k: v.detach().cpu() for k, v in sim.global_params.items()}}


def tiny_recovery_parity() -> dict:
    """``tiny_recovery_parity``: the CPU tests' tiny supervised drill once on
    the card and once on the CPU: the same verdicts, suspects, rungs,
    rollbacks, roster and ledger document, the losses and final params
    within 5e-4."""
    root = ckpt_dir("tiny_recovery")
    runs = {dev: tiny_recovery_drill(dev, root) for dev in ("cuda", "cpu")}
    card, cpu = runs["cuda"], runs["cpu"]
    for key in ("rounds", "verdicts", "rungs", "suspects", "rollback", "resume_rounds",
                "roster", "ledger"):
        if card[key] != cpu[key]:
            fail(f"tiny_recovery_parity: {key} card {card[key]} vs cpu {cpu[key]}")
    loss_err = max(abs(a - b) for a, b in zip(card["fit_losses"], cpu["fit_losses"]))
    param_err = max(float((card["params"][k] - cpu["params"][k]).abs().max())
                    for k in cpu["params"])
    if not (loss_err <= 5e-4 and param_err <= 5e-4) or card["rounds"] != list(
            range(1, TINY_RECOVERY_ROUNDS + 1)):
        fail(f"tiny_recovery_parity: loss err {loss_err}, param err {param_err}, "
             f"rounds {card['rounds']}")
    drop_dirs(root)
    out = {"phase": "tiny_recovery_parity", "rungs": card["rungs"],
           "suspects": card["suspects"], "roster": card["roster"],
           "verdicts": card["verdicts"], "resume_rounds": card["resume_rounds"],
           "max_abs_loss_err": loss_err, "max_abs_param_err": param_err}
    print(json.dumps(out))
    return out


class _Timed:
    """Sums the wall of every call of one bound method of an object (a
    measurement wrapper on the instance; the method itself is unchanged)."""

    def __init__(self, obj, name: str):
        self.total, self.calls, inner = 0.0, 0, getattr(obj, name)

        def timed(*args, **kwargs):
            t0 = time.time()
            try:
                return inner(*args, **kwargs)
            finally:
                self.total += time.time() - t0
                self.calls += 1

        setattr(obj, name, timed)


def recovery_dp_arm(data, route: str, root: str, tag: str, dp, *, factor: float,
                    fault: bool, recovery) -> dict:
    """One arm of ``recovery_dp_cifar_cnn``: the DP path under
    ``InstanceLevelDpServer`` with a frame every round and observability on
    (the drill's watchdog at ``factor``); ``fault`` adds the scale fault
    on ``RECOVERY_FAULTED`` from round 2, ``recovery`` a
    ``RecoveryPolicy``. A halt is returned, not raised: the caller says
    which arms must halt."""
    from fl4health_tpu_torch.observability import TrainingHealthError
    from fl4health_tpu_torch.resilience import RecoverySupervisor
    from fl4health_tpu_torch.server.servers import InstanceLevelDpServer

    from fl4health_tpu_torch.checkpointing import SimulationStateCheckpointer

    obs_dir = os.path.join(root, f"{tag}_obs")
    # the reference drill's ring of 8 generations, a frame every round
    sim = build_dp_sim(data, torch.bfloat16, "cuda", DP_SIGMA, seed=0, execution_mode=route,
                       state_checkpointer=SimulationStateCheckpointer(
                           os.path.join(root, f"{tag}_ck"), keep=8, checkpoint_every=1),
                       observability=recovery_obs(obs_dir, factor),
                       fault_plan=scale_fault_plan(RECOVERY_FAULTED) if fault else None,
                       recovery=recovery)
    timers = {"restore": _Timed(sim, "_maybe_resume"), "bundle": _Timed(sim, "_dump_postmortem")}
    if recovery is not None:
        sim._recovery_supervisor = RecoverySupervisor(sim, recovery)
        timers["engage"] = _Timed(sim._recovery_supervisor, "_engage")
    server = InstanceLevelDpServer(sim, DP_SIGMA, BATCH)
    dp.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    halt, epsilon = None, None
    try:
        _, epsilon = server.fit(RECOVERY_ROUNDS)
    except TrainingHealthError as e:
        halt = {"round": e.round, "check": e.check, "clients": list(e.clients)}
    torch.cuda.synchronize()
    wall = time.time() - t0
    from fl4health_tpu_torch.observability.bundle import list_bundles

    out = {"sim": sim, "halt": halt, "epsilon": epsilon, "wall_s": wall,
           "launches": dict(dp.LAUNCHES), "dispatched": sim.rounds_dispatched,
           "bundles": len(list_bundles(obs_dir)), "obs_dir": obs_dir,
           "fit_losses": [r.fit_losses["backward"] for r in sim.history],
           **{f"{k}_s": t.total for k, t in timers.items()},
           **{f"{k}_calls": t.calls for k, t in timers.items()}}
    if out["launches"] != dp_launches(sim.rounds_dispatched):
        fail(f"recovery_dp_cifar_cnn {route} {tag}: launches {out['launches']} for "
             f"{sim.rounds_dispatched} dispatched rounds, expected "
             f"{dp_launches(sim.rounds_dispatched)}")
    return out


def recovery_dp_cifar_cnn(dp) -> dict:
    """``recovery_dp_cifar_cnn``, deterministic flags: the DP path at full
    width (64 clients of 160 rows, batch 32, 5 DP-SGD steps, C 1, sigma 1,
    bf16 compute on f32 params) under ``InstanceLevelDpServer``, a frame
    every round, 5 rounds, on the chunked and the pipelined route, in four
    arms: fault-free; a ``RecoveryPolicy`` armed with no fault (bit-equal to
    the fault-free arm: history, global params, server state); the scale
    fault (-15 on the 16 clients of ``RECOVERY_FAULTED`` from round 2)
    unsupervised (the watchdog halts it on a loss divergence, one bundle);
    and the fault supervised (all 5 rounds, the roster holds the 16
    clients; ``max_suspects`` leaves room for 4 more, printed). K1 and K2
    launch 5 and
    40 times each round the simulation dispatched (``rounds_dispatched``).
    Printed: the rungs, the rollbacks, the roster, the bundles, the reported
    epsilon, and the supervised wall against the fault-free one split into
    restore, bundle, engagement and replayed rounds."""
    from fl4health_tpu_torch.resilience import RecoveryPolicy

    data = image_datasets(DP_CLIENTS, DP_TRAIN, DP_VAL, (32, 32, 3))
    out = {"phase": "recovery_dp_cifar_cnn", "clients": DP_CLIENTS, "rounds": RECOVERY_ROUNDS,
           "faulted": list(RECOVERY_FAULTED), "fault": "scale -15, probability 1, round >= 2"}
    policy = RecoveryPolicy(quarantine_rounds=0, max_suspects=len(RECOVERY_FAULTED) + 4)
    out["policy"] = {"rungs": list(policy.rungs), "max_suspects": policy.max_suspects,
                     "quarantine_rounds": policy.quarantine_rounds}
    for route in ("chunked", "pipelined"):
        root = ckpt_dir(f"recovery_{route}")
        factor = RECOVERY_FACTOR
        while True:
            free = recovery_dp_arm(data, route, root, f"free_{factor}", dp, factor=factor,
                                   fault=False, recovery=None)
            if free["halt"] is None:
                break
            factor = round(factor + 0.2, 2)
            if factor > 3.0:
                fail(f"recovery_dp_cifar_cnn {route}: the fault-free arm halts "
                     f"({free['halt']}) at every factor up to 3.0")
        armed = recovery_dp_arm(data, route, root, "armed", dp, factor=factor, fault=False,
                                recovery=policy)
        if (armed["halt"] is not None or not history_equal(free["sim"], armed["sim"])
                or not states_equal(free["sim"], armed["sim"])
                or armed["sim"]._recovery_supervisor._total_attempts):
            fail(f"recovery_dp_cifar_cnn {route}: the armed idle policy is not bit-equal "
                 "to the fault-free run")
        bad = recovery_dp_arm(data, route, root, "unsupervised", dp, factor=factor,
                              fault=True, recovery=None)
        if (bad["halt"] is None or bad["halt"]["check"] != "loss_divergence"
                or bad["bundles"] != 1):
            fail(f"recovery_dp_cifar_cnn {route}: the faulted unsupervised arm ended with "
                 f"{bad['halt']} and {bad['bundles']} bundles (losses {bad['fit_losses']})")
        sup = recovery_dp_arm(data, route, root, "supervised", dp, factor=factor, fault=True,
                              recovery=policy)
        roster = sorted(sup["sim"]._recovery_supervisor._quarantine)
        if (sup["halt"] is not None or [r.round for r in sup["sim"].history]
                != list(range(1, RECOVERY_ROUNDS + 1))
                or not set(RECOVERY_FAULTED) <= set(roster)):
            fail(f"recovery_dp_cifar_cnn {route}: the supervised arm ended with "
                 f"{sup['halt']}, rounds {[r.round for r in sup['sim'].history]}, "
                 f"roster {roster}")
        verdicts, events = recovery_trail(sup["obs_dir"])
        engages = [e for e in events if e.get("phase") == "engage"]
        replayed = sup["dispatched"] - RECOVERY_ROUNDS
        # the fault-free wall: the faster of the two fault-free arms (the
        # first run of a route pays its first-use costs)
        free_wall = min(free["wall_s"], armed["wall_s"])
        extra = sup["wall_s"] - free_wall
        out[route] = {
            "watchdog_factor": factor,
            "fault_free": {"fit_losses": free["fit_losses"], "epsilon": free["epsilon"],
                           "wall_s": free["wall_s"], "launches": free["launches"],
                           "dispatched": free["dispatched"]},
            "armed_idle_bit_equal": True, "armed_wall_s": armed["wall_s"],
            "unsupervised": {"halt": bad["halt"], "bundles": bad["bundles"],
                             "fit_losses": bad["fit_losses"], "dispatched": bad["dispatched"],
                             "launches": bad["launches"]},
            "supervised": {
                "rungs": [e["rung"] for e in engages],
                "verdict_rounds": [e["round"] for e in engages],
                "suspects": [e["suspects"] for e in engages],
                "rolled_back": [{"from_round": e["round"], "resume_round": e["resume_round"],
                                 **e["rollback"]} for e in engages],
                "roster": roster, "beyond_faulted": sorted(set(roster) - set(RECOVERY_FAULTED)),
                "bundles": sup["bundles"], "verdicts": verdicts, "epsilon": sup["epsilon"],
                "epsilon_charged_rounds": RECOVERY_ROUNDS,
                "dispatched": sup["dispatched"], "launches": sup["launches"],
                "fit_losses": sup["fit_losses"],
                "wall_s": sup["wall_s"], "fault_free_wall_s": free_wall,
                "restore_s": sup["restore_s"], "restores": sup["restore_calls"],
                "bundle_s": sup["bundle_s"], "engage_s": sup["engage_s"],
                "replayed_rounds": replayed,
                "replayed_s": extra - sup["restore_s"] - sup["bundle_s"] - sup["engage_s"]}}
        for arm in (free, armed, bad, sup):
            del arm["sim"]
        drop_dirs(root)
        torch.cuda.empty_cache()
    print(card_line())
    print(json.dumps(out))
    return out


def poisoned_source(source, poisoned: int):
    """``source`` with client ``poisoned``'s training features NaN; every
    other client reads through."""
    from fl4health_tpu_torch.server.registry import RegistryDataSource

    class Poisoned(RegistryDataSource):
        n_clients = source.n_clients

        def train_sizes(self):
            return source.train_sizes()

        def val_sizes(self):
            return source.val_sizes()

        def client_train(self, i):
            x, y = source.client_train(i)
            return (np.full_like(np.asarray(x), np.nan) if i == poisoned else x), y

        def client_val(self, i):
            return source.client_val(i)

    return Poisoned()


def recovery_cohort(dp, source) -> dict:
    """``recovery_cohort``: the pipelined cohort route at N 1,000 with 64
    slots (``cohort_dp_cifar_cnn``'s registry), a strict failure policy and
    one registry client, drawn in round 1, whose training features are NaN:
    the supervised run quarantines that registry id and runs its 3 rounds
    after the restart; the route's reason, the roster, the rounds
    dispatched and the K1/K2 launches (5 and 40 a dispatched round)."""
    from fl4health_tpu_torch import rng
    from fl4health_tpu_torch.resilience import RecoveryPolicy
    from fl4health_tpu_torch.server.client_manager import FixedFractionManager
    from fl4health_tpu_torch.server.simulation import EXEC_PIPELINED, FailurePolicy

    n = COHORT_SIZES[0]
    first = FixedFractionManager(n, COHORT_SLOTS / n).sample_indices(
        rng.fold_in(rng.PRNGKey(0, "cpu"), 2001), 1, COHORT_SLOTS)[0]
    poisoned = int(first[7])
    sim = build_cohort_sim(poisoned_source(source, poisoned), n,
                           failure_policy=FailurePolicy(accept_failures=False),
                           recovery=RecoveryPolicy(rungs=("quarantine",), quarantine_rounds=0))
    mode = sim._select_execution_mode(COHORT_ROUNDS)
    dp.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    hist = sim.fit(COHORT_ROUNDS)
    torch.cuda.synchronize()
    wall = time.time() - t0
    sup = sim._recovery_supervisor
    launches = dict(dp.LAUNCHES)
    if (sup.quarantined_ids(1) != [poisoned] or [r.round for r in hist]
            != list(range(1, COHORT_ROUNDS + 1)) or launches != dp_launches(sim.rounds_dispatched)
            or mode[0] != EXEC_PIPELINED or not all(np.isfinite(r.fit_losses["backward"])
                                                 for r in hist)):
        fail(f"recovery_cohort: roster {sup.quarantined_ids(1)} (poisoned {poisoned}), mode "
             f"{mode}, rounds {[r.round for r in hist]}, launches {launches} for "
             f"{sim.rounds_dispatched} dispatched")
    out = {"phase": "recovery_cohort", "registry_size": n, "slots": COHORT_SLOTS,
           "mode": list(mode), "poisoned_registry_id": poisoned,
           "roster": sup.quarantined_ids(1), "attempts": sup._total_attempts,
           "last_verdict": ledger_doc(sup)["last_verdict"],
           "dispatched": sim.rounds_dispatched, "launches": launches, "wall_s": wall,
           "fit_losses": [r.fit_losses["backward"] for r in hist]}
    del sim
    torch.cuda.empty_cache()
    print(json.dumps(out))
    return out


def hoisting_server_lr() -> dict:
    """``hoisting_server_lr``, deterministic flags: the DP path at full width
    under ``fed_adam``; ``apply_state_scalars`` sets a fresh run's
    ``server_lr`` from 0.01 to 0.05, and its 2 rounds are bit-equal
    (history, params, server state) to a run built with 0.05."""
    from fl4health_tpu_torch.strategies.fedopt import fed_adam
    from fl4health_tpu_torch.sweep.hoisting import apply_state_scalars

    data = image_datasets(DP_CLIENTS, DP_TRAIN, DP_VAL, (32, 32, 3))
    built = build_dp_sim(data, torch.bfloat16, "cuda", DP_SIGMA, seed=0,
                         strategy=fed_adam(lr=0.05))
    rebound = build_dp_sim(data, torch.bfloat16, "cuda", DP_SIGMA, seed=0,
                           strategy=fed_adam(lr=0.01))
    rebound.server_state = apply_state_scalars(rebound.strategy, rebound.server_state,
                                               {"server_lr": 0.05})
    built.fit(2)
    rebound.fit(2)
    torch.cuda.synchronize()
    lr = rebound.server_state.opt_state.hyperparams["learning_rate"]
    equal = history_equal(built, rebound) and states_equal(built, rebound)
    if not equal or float(lr) != float(np.float32(0.05)):
        fail(f"hoisting_server_lr: rebound run equal={equal}, lr {float(lr)}")
    out = {"phase": "hoisting_server_lr", "strategy": "fed_adam", "from": 0.01, "to": 0.05,
           "rounds": 2, "bit_equal": equal, "lr_leaf": [str(lr.dtype), float(lr)],
           "fit_losses": [r.fit_losses["backward"] for r in rebound.history]}
    del built, rebound
    torch.cuda.empty_cache()
    print(json.dumps(out))
    return out


OPS_ROUNDS = 2
OPS_DRILL_ROUNDS = 4
OPS_TOKEN = "ops-token"


class DeltaAround:
    """Wraps a callable: the device bytes allocated and the K1-K5 launch
    counts moved by each call, read around it after a synchronize."""

    def __init__(self, fn, kernels):
        self.fn, self.kernels, self.deltas = fn, kernels, []

    def __call__(self, *args, **kw):
        torch.cuda.synchronize()
        m0, l0 = torch.cuda.memory_allocated(), self._launches()
        out = self.fn(*args, **kw)
        torch.cuda.synchronize()
        l1 = self._launches()
        self.deltas.append({"bytes": torch.cuda.memory_allocated() - m0,
                            "launches": {k: l1[k] - l0[k] for k in l0}})
        return out

    def _launches(self) -> dict:
        return {k: v for m in self.kernels for k, v in m.LAUNCHES.items()}


def post_json(url: str, body: dict, token: str) -> tuple[int, dict]:
    """One POST of a JSON body with the admin header: (status, JSON body)."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, data=json.dumps(body).encode(), method="POST",
                                 headers={"Content-Type": "application/json",
                                          "X-Admin-Token": token})
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def ops_dp_cifar_cnn(fa, dp) -> dict:
    """``ops_dp_cifar_cnn``, deterministic flags: the introspection and
    operations plane on ``dp_cifar_cnn`` at full width.

    - ``InstanceLevelDpServer`` for 2 pipelined rounds with introspection
      on, an SLO policy the run breaches (``max_eval_loss``), an admin token
      and the scrape endpoint, against the same run with observability off:
      params and history bit-equal, K1/K2 launches equal (10/80); the
      introspection run moves no device byte and no K1-K5 count;
      ``/healthz`` reads ``degraded: eval_loss`` at round 2's report.
    - ``fit_round_t``'s dot and convolution flops equal the reference
      FlopCounterMode's (``hloscan.reference_flop_counter``) over one real
      round on the same arguments; its ``dp_clip`` row holds 45 custom calls
      (5 steps x (1 K1 + 8 K2)); conservation holds. Printed a round:
      ``mfu_pct``, ``tflops_measured``; the introspected peak against
      ``max_memory_allocated`` above the run's start; ``fl_hbm_headroom_bytes``.
    - the live drill: ``fed_adam`` on the DP path for 4 rounds, a ``POST
      /admin/scalars`` of ``server_lr`` from round 2's data provider (the
      producer thread) applying at round 2's boundary; no extension build
      after round 1; a replay through ``schedule()`` bit-equal.
    - the flash kernels' fake branch: one introspected round of
      ``transformer_long`` at depth 1 reports K3-K5 as custom calls, with 0
      launches."""
    from fl4health_tpu_torch.observability import (MetricsRegistry, Observability, SLOPolicy,
                                                   Tracer, hloscan)
    from fl4health_tpu_torch.server.servers import InstanceLevelDpServer
    from fl4health_tpu_torch.server.simulation import EXEC_PIPELINED
    from fl4health_tpu_torch.strategies.fedopt import fed_adam

    t_phase = time.time()
    data = image_datasets(DP_CLIENTS, DP_TRAIN, DP_VAL, (32, 32, 3))
    out = {"phase": "ops_dp_cifar_cnn", "clients": DP_CLIENTS, "rounds": OPS_ROUNDS}

    def armed(**kw):
        return Observability(enabled=True, registry=MetricsRegistry(), tracer=Tracer(), **kw)

    off = build_dp_sim(data, torch.bfloat16, "cuda", DP_SIGMA, seed=0,
                       execution_mode="pipelined")
    dp.reset_launch_counts()
    InstanceLevelDpServer(off, noise_multiplier=DP_SIGMA, batch_size=BATCH).fit(OPS_ROUNDS)
    torch.cuda.synchronize()
    launches = {"off": dict(dp.LAUNCHES)}
    obs = armed(slo=SLOPolicy(max_eval_loss=1e-3, short_window=1, long_window=1),
                admin_token=OPS_TOKEN, http_port=0)
    probe = ScrapeAtRound(obs, OPS_ROUNDS)
    on = build_dp_sim(data, torch.bfloat16, "cuda", DP_SIGMA, seed=0,
                      execution_mode="pipelined", observability=obs, reporters=[probe])
    on._val_batches()  # the route's cached val split, made before the delta is read
    around = on._introspect_programs = DeltaAround(on._introspect_programs, (fa, dp))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start_bytes = torch.cuda.memory_allocated()  # earlier phases' and the off run's
    dp.reset_launch_counts()
    InstanceLevelDpServer(on, noise_multiplier=DP_SIGMA, batch_size=BATCH).fit(OPS_ROUNDS)
    torch.cuda.synchronize()
    launches["on"] = dict(dp.LAUNCHES)
    peak_run = torch.cuda.max_memory_allocated() - start_bytes
    if launches["on"] != launches["off"] or launches["on"] != dp_launches(OPS_ROUNDS):
        fail(f"ops_dp_cifar_cnn: launches {launches}, expected {dp_launches(OPS_ROUNDS)}")
    if not trajectory_equal(off, on):
        fail("ops_dp_cifar_cnn: the armed run is not bit-equal to the off run")
    zero = {k: 0 for k in (*fa.LAUNCHES, *dp.LAUNCHES)}
    if around.deltas != [{"bytes": 0, "launches": zero}]:
        fail(f"ops_dp_cifar_cnn: introspection moved the device: {around.deltas}")
    if probe.seen.get("healthz") != (200, "degraded: eval_loss\n"):
        fail(f"ops_dp_cifar_cnn: /healthz at round {OPS_ROUNDS}: {probe.seen.get('healthz')}")
    intro = obs.introspector
    if sorted(intro.reports) != ["eval_round_t", "fit_round_t"]:
        fail(f"ops_dp_cifar_cnn: introspected {sorted(intro.reports)}")
    fit_rep = intro.reports["fit_round_t"]
    rows = {r["stage"]: r for r in fit_rep.stages}
    cons = hloscan.conservation(fit_rep.stages, fit_rep.flops, fit_rep.bytes_accessed)
    if rows.get("dp_clip", {}).get("custom_calls") != LOCAL_STEPS * (1 + len(CIFAR_LEAVES)):
        fail(f"ops_dp_cifar_cnn: dp_clip row {rows.get('dp_clip')}")
    if not cons["ok"]:
        fail(f"ops_dp_cifar_cnn: conservation {cons}")
    # one real round on the same arguments under the reference counter
    from fl4health_tpu_torch import rng as trng

    ref = hloscan.reference_flop_counter()
    val_batches = on._val_batches()[0]
    mask = on.client_manager.sample(trng.fold_in(on.rng, 2000 + 1), 1)
    with ref:
        on._fit_round_t(on.server_state, on.client_states, on._round_batches(1), mask, 1,
                        val_batches)
    torch.cuda.synchronize()
    counted = intro.counters["fit_round_t"].dot_flops
    if counted != ref.get_total_flops() or counted <= 0:
        fail(f"ops_dp_cifar_cnn: counted dot+conv flops {counted}, reference "
             f"FlopCounterMode {ref.get_total_flops()}")
    rounds = [e for e in obs.registry.events if e["event"] == "round"]
    snap = obs.registry.snapshot()
    for e in rounds:
        # beside the rate over the round's wall, the rate over the fence's
        # wait alone (the tail after the last dispatch), which JAX divides by
        wait = e["device_wait_s"]
        print(json.dumps({"ops_round": e["round"], "mfu_pct": e.get("mfu_pct"),
                          "tflops_measured": e.get("tflops_measured"),
                          "program_flops_round": e.get("program_flops_round"),
                          "program_exec_s": e.get("program_exec_s"),
                          "device_wait_s": wait,
                          "tflops_over_wait": (e["program_flops_round"] / wait / 1e12
                                               if wait > 0 and "program_flops_round" in e
                                               else None)}))
    if any(e.get("mfu_pct") is None for e in rounds):
        fail("ops_dp_cifar_cnn: a round record without mfu_pct on the card")
    out["introspection"] = {
        "bit_equal": True, "launches": launches, "introspect_deltas": around.deltas,
        "programs": {n: {k: r.as_dict()[k] for k in
                         ("flops", "bytes_accessed", "transcendentals", "argument_bytes",
                          "output_bytes", "temp_bytes", "peak_hbm_bytes",
                          "compile_seconds")} for n, r in intro.reports.items()},
        "fit_round_t_stages": {s: {k: r[k] for k in ("flops", "bytes_accessed", "ops",
                                                     "custom_calls", "fusion_headroom_bytes")}
                               for s, r in rows.items()},
        "kernel_calls": intro.counters["fit_round_t"].kernel_calls,
        "dot_conv_flops": counted, "reference_flop_counter": ref.get_total_flops(),
        "conservation": cons,
        "peak_introspected_bytes": intro.max_program_footprint(),
        "max_memory_allocated_above_start_bytes": peak_run,
        "hbm_headroom_bytes": snap.get("fl_hbm_headroom_bytes"),
        "healthz": list(probe.seen["healthz"])}
    del off, on
    torch.cuda.empty_cache()

    # the live drill, and its replay through schedule()
    posted = {}

    def poster(obs_):
        def provider(rnd):
            if rnd == 2 and "resp" not in posted:
                posted["resp"] = post_json(obs_.scrape_url + "/admin/scalars",
                                           {"server_lr": 0.02}, OPS_TOKEN)
            return None
        return provider

    live_obs = armed(admin_token=OPS_TOKEN, http_port=0, introspection=False)
    live = build_dp_sim(data, torch.bfloat16, "cuda", DP_SIGMA, seed=0,
                        strategy=fed_adam(lr=0.05), observability=live_obs,
                        train_data_provider=poster(live_obs))
    live.fit(OPS_DRILL_ROUNDS)
    replay_obs = armed(admin_token=OPS_TOKEN, introspection=False)
    replay_obs.admin.schedule(2, {"server_lr": 0.02})
    replay = build_dp_sim(data, torch.bfloat16, "cuda", DP_SIGMA, seed=0,
                          strategy=fed_adam(lr=0.05), observability=replay_obs,
                          train_data_provider=lambda rnd: None)
    replay.fit(OPS_DRILL_ROUNDS)
    torch.cuda.synchronize()
    journal = live_obs.admin.journal()
    compiles = [e["compiles"] for e in live_obs.registry.events if e["event"] == "round"]
    lr = float(live.server_state.opt_state.hyperparams["learning_rate"])
    if (posted.get("resp", (None,))[0] != 200
            or [(j["round"], j["scalars"]) for j in journal] != [(2, {"server_lr": 0.02})]
            or lr != float(np.float32(0.02))):
        fail(f"ops live drill: POST {posted.get('resp')}, journal {journal}, lr {lr}")
    if any(compiles[1:]):
        fail(f"ops live drill: extension builds after round 1: {compiles}")
    if not trajectory_equal(live, replay):
        fail("ops live drill: the schedule() replay is not bit-equal to the live run")
    out["live_drill"] = {"rounds": OPS_DRILL_ROUNDS, "post": posted["resp"][0],
                         "journal": journal, "server_lr_leaf": lr, "compiles": compiles,
                         "replay_bit_equal": True,
                         "fit_losses": [r.fit_losses["backward"] for r in live.history]}
    del live, replay
    torch.cuda.empty_cache()

    # the flash kernels' fake branch at transformer_long's width, depth 1
    cfg = dict(vocab_size=8192, n_classes=4, d_model=512, n_heads=8, n_layers=1,
               d_ff=2048, max_len=T)
    val_rows = 16
    tdata = text_datasets(8192, T, BATCH * LOCAL_STEPS + val_rows, BATCH * LOCAL_STEPS)
    tobs = armed()
    tsim = build_sim(cfg, tdata, torch.bfloat16, "cuda", seed=0, observability=tobs)
    fa.reset_launch_counts()
    tsim._introspect_programs(EXEC_PIPELINED, 1)
    torch.cuda.synchronize()
    calls = {n: c.kernel_calls for n, c in tobs.introspector.counters.items()}
    # a step: the forward and remat's recompute, dQ, dK/dV; an eval step: a forward
    want = {"fit_round_t": {"flash_fwd": 2 * LOCAL_STEPS, "flash_bwd_dq": LOCAL_STEPS,
                            "flash_bwd_dkv": LOCAL_STEPS},
            "eval_round_t": {"flash_fwd": -(-val_rows // BATCH)}}
    if calls != want or any(fa.LAUNCHES.values()):
        fail(f"ops transformer fake branch: calls {calls} (want {want}), "
             f"launches {dict(fa.LAUNCHES)}")
    out["flash_fake_branch"] = {"calls": calls, "launches": dict(fa.LAUNCHES),
                                "flops": {n: r.flops for n, r in tobs.introspector.reports.items()}}
    del tsim
    torch.cuda.empty_cache()
    out["phase_s"] = time.time() - t_phase
    print(card_line())
    print(json.dumps(out))
    return out


SWEEP_ROUNDS = 2
SWEEP_COHORTS = (48, 64)  # 48 pads to the one bucket, 64
SWEEP_LRS = (0.01, 0.03)  # fed_adam's server_lr axis
SWEEP_SEED = 5
SWEEP_SALT = 20_000  # the uneven partitioner's keys: PRNGKey(SWEEP_SALT + i)
SWEEP_LAM = 0.5  # MR-MTL's drift weight
_SWEEP_DATA: dict = {}


def uneven_datasets(n_clients: int) -> list:
    """``dp_cifar_cnn``'s generator salted: client i's rows from
    ``PRNGKey(SWEEP_SALT + i)``, 160 - 4 (1 + i mod 8) train rows (128-156,
    so a group's 160-row budget pads them) and 64 val rows."""
    from fl4health_tpu_torch import rng
    from fl4health_tpu_torch.datasets.synthetic import synthetic_classification
    from fl4health_tpu_torch.server.simulation import ClientDataset

    out = []
    for i in range(n_clients):
        x, y = (a.cpu() for a in synthetic_classification(
            rng.PRNGKey(SWEEP_SALT + i, "cuda"), DP_TRAIN + DP_VAL, (32, 32, 3), 10))
        n = DP_TRAIN - 4 * (1 + i % 8)
        out.append(ClientDataset(x[:n], y[:n], x[DP_TRAIN:], y[DP_TRAIN:]))
    return out


def sweep_partition(name: str, cohort: int) -> list:
    """The sweep's partitioners: the first ``cohort`` clients of 64, drawn
    once on the card (``even``: ``dp_cifar_cnn``'s own clients)."""
    if name not in _SWEEP_DATA:
        _SWEEP_DATA[name] = (image_datasets(DP_CLIENTS, DP_TRAIN, DP_VAL, (32, 32, 3))
                             if name == "even" else uneven_datasets(DP_CLIENTS))
    return _SWEEP_DATA[name][:cohort]


def sweep_clients() -> dict:
    """The grid's client algorithms: DP-SGD, and DP over MR-MTL, both on
    CifarNet in f32 (C 1, sigma 1)."""
    from fl4health_tpu_torch.clients import engine
    from fl4health_tpu_torch.clients.ditto import MrMtlClientLogic
    from fl4health_tpu_torch.clients.instance_level_dp import (InstanceLevelDpClientLogic,
                                                               InstanceLevelDpMixin)
    from fl4health_tpu_torch.models.cnn import CifarNet

    class DpMrMtlClientLogic(InstanceLevelDpMixin, MrMtlClientLogic):
        pass

    def model():
        return engine.from_module(CifarNet(dtype=torch.float32))

    dp = dict(clipping_bound=DP_CLIP, noise_multiplier=DP_SIGMA)
    return {"dp": lambda: InstanceLevelDpClientLogic(model(), engine.masked_cross_entropy,
                                                     **dp),
            "dp_mrmtl": lambda: DpMrMtlClientLogic(model(), engine.masked_cross_entropy,
                                                   lam=SWEEP_LAM, **dp)}


def sweep_spec(**overrides):
    """The 24-cell grid: {fedavg, fedadam x server_lr 0.01/0.03} x {dp,
    dp_mrmtl} x {even, uneven} x cohorts {48, 64} in one bucket of 64, seed
    5, packs of 8: 4 groups."""
    from fl4health_tpu_torch import optim
    from fl4health_tpu_torch.metrics import efficient
    from fl4health_tpu_torch.metrics.base import MetricManager
    from fl4health_tpu_torch.strategies.fedavg import FedAvg
    from fl4health_tpu_torch.strategies.fedopt import fed_adam
    from fl4health_tpu_torch.sweep import SweepSpec

    kw = dict(strategies={"fedavg": FedAvg, "fedadam": lambda: fed_adam(lr=SWEEP_LRS[0])},
              clients=sweep_clients(),
              partitioners={name: (lambda c, name=name: sweep_partition(name, c))
                            for name in ("even", "uneven")},
              rounds=SWEEP_ROUNDS, batch_size=BATCH, local_steps=LOCAL_STEPS,
              tx=lambda: optim.sgd(0.05),
              metrics=lambda: MetricManager((efficient.accuracy(),)),
              seeds=(SWEEP_SEED,), cohort_sizes=SWEEP_COHORTS,
              scalars={"server_lr": SWEEP_LRS}, cohort_buckets=(DP_CLIENTS,),
              pack=True, max_pack=8)
    kw.update(overrides)
    return SweepSpec(**kw)


def sweep_standalone(spec, cell, dp) -> dict:
    """The cell's configuration as an ordinary chunked ``fit`` on the card
    (``build_dp_sim`` with the cell's logic, strategy and seed, f32): its
    trajectory, wall and launches."""
    from fl4health_tpu_torch.strategies.fedopt import fed_adam

    strategy = (fed_adam(lr=cell.scalar_dict["server_lr"]) if cell.strategy == "fedadam"
                else spec.strategies[cell.strategy]())
    sim = build_dp_sim(sweep_partition(cell.partitioner, cell.cohort), torch.float32, "cuda",
                       DP_SIGMA, seed=cell.seed, batch=spec.batch_size,
                       local_steps=spec.local_steps, strategy=strategy,
                       logic=spec.clients[cell.client](), execution_mode="chunked")
    dp.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    hist = sim.fit(spec.rounds)
    torch.cuda.synchronize()
    return {"fit": [r.fit_losses["backward"] for r in hist],
            "eval": [r.eval_losses["checkpoint"] for r in hist],
            "wall_s": time.time() - t0, "launches": dict(dp.LAUNCHES)}


def tiny_sweep_spec(device: str):
    """The CPU tests' grid (tests/test_torch_sweep.py): an Mlp(12) on 6
    features, 3 clients of 24-32 train and 8 val rows, {fedavg, fedadam(0.1)}
    x {sgd, mrmtl(0.5)} x seeds {5, 7}, 2 rounds, batch 8, 2 local steps."""
    from fl4health_tpu_torch import optim, rng
    from fl4health_tpu_torch.clients import engine
    from fl4health_tpu_torch.clients.ditto import MrMtlClientLogic
    from fl4health_tpu_torch.datasets.synthetic import synthetic_classification
    from fl4health_tpu_torch.models.cnn import Mlp
    from fl4health_tpu_torch.server.simulation import ClientDataset
    from fl4health_tpu_torch.strategies.fedavg import FedAvg
    from fl4health_tpu_torch.strategies.fedopt import fed_adam
    from fl4health_tpu_torch.sweep import SweepSpec

    def partition(cohort):
        out = []
        for i in range(cohort):
            x, y = synthetic_classification(rng.PRNGKey(i, "cpu"), 40, (6,), 3)
            n = 24 + 4 * (i % 3)
            out.append(ClientDataset(x[:n], y[:n], x[32:], y[32:]))
        return out

    def model():
        return engine.from_module(Mlp(6, (12,), 3))

    return SweepSpec(
        strategies={"fedavg": FedAvg, "fedadam": lambda: fed_adam(0.1)},
        clients={"sgd": lambda: engine.ClientLogic(model(), engine.masked_cross_entropy),
                 "mrmtl": lambda: MrMtlClientLogic(model(), engine.masked_cross_entropy,
                                                   lam=SWEEP_LAM)},
        partitioners={"p0": partition}, rounds=2, batch_size=8, local_steps=2,
        tx=lambda: optim.sgd(0.05), seeds=(5, 7), cohort_sizes=(3,))


def tiny_sweep_parity() -> dict:
    """The CPU tests' grid on the card and on the CPU: every cell within
    5e-4 (no kernel on this path)."""
    from fl4health_tpu_torch.sweep import run_sweep

    card, cpu = (run_sweep(tiny_sweep_spec(d), device=d) for d in ("cuda", "cpu"))
    err = 0.0
    for a, b in zip(card.cells, cpu.cells):
        if a.cell.label() != b.cell.label():
            fail(f"tiny sweep: cell {a.cell.label()} against {b.cell.label()}")
        err = max(err, float(np.max(np.abs(np.subtract(a.fit_losses + a.eval_losses,
                                                        b.fit_losses + b.eval_losses)))))
    if len(card.cells) != 8 or not err <= 5e-4:
        fail(f"tiny sweep: {len(card.cells)} cells, card-vs-CPU max abs err {err}")
    return {"cells": len(card.cells), "max_abs_err": err}


def twin_check(sim, kind: str) -> dict:
    """After the last round: Ditto's global subtrees equal over the clients
    and its personal ones not; MR-MTL's params off the aggregate."""
    params = sim.client_states.params
    if kind == "ditto":
        globals_equal = client_spread(params, "global_model/") == 0.0
        personal_spread = client_spread(params, "personal_model/")
        if not globals_equal or not personal_spread > 1e-6:
            fail(f"ditto_cifar_cnn: globals equal {globals_equal}, "
                 f"personal spread {personal_spread}")
        return {"globals_equal": globals_equal, "personal_spread": personal_spread}
    agg = torch.cat([v.reshape(-1) for v in sim.global_params.values()])
    mine = torch.cat([v.reshape(v.shape[0], -1) for v in params.values()], 1)
    off = float((mine - agg[None]).abs().max())
    if not off > 1e-6:
        fail(f"mrmtl_cifar_cnn: clients' params {off} off the aggregate")
    return {"max_off_aggregate": off}


def personalized_cifar_cnn(kind: str, dp) -> dict:
    """``ditto_cifar_cnn`` (TwinModel(CifarNet, CifarNet), adaptive Ditto,
    the global copy exchanged, ``DittoServer``) or ``mrmtl_cifar_cnn``
    (MR-MTL with ``KeepLocalExchanger``, ``MrMtlServer``): the 64
    ``dp_cifar_cnn`` clients, batch 32, 5 SGD(0.05) steps, f32,
    ``FedAvgWithAdaptiveConstraint``; a cold round, then a warm one timed."""
    from fl4health_tpu_torch import optim
    from fl4health_tpu_torch.clients import engine
    from fl4health_tpu_torch.clients.ditto import (DittoClientLogic, KeepLocalExchanger,
                                                   MrMtlClientLogic)
    from fl4health_tpu_torch.exchange.exchanger import FixedLayerExchanger
    from fl4health_tpu_torch.metrics import efficient
    from fl4health_tpu_torch.metrics.base import MetricManager
    from fl4health_tpu_torch.models.bases import TwinModel
    from fl4health_tpu_torch.models.cnn import CifarNet
    from fl4health_tpu_torch.server.servers import DittoServer, MrMtlServer
    from fl4health_tpu_torch.server.simulation import FederatedSimulation
    from fl4health_tpu_torch.strategies.fedprox import FedAvgWithAdaptiveConstraint

    if kind == "ditto":
        logic = DittoClientLogic(engine.from_module(TwinModel(CifarNet(dtype=torch.float32),
                                                              CifarNet(dtype=torch.float32))),
                                 engine.masked_cross_entropy, adaptive=True)
        exchanger, server_cls = FixedLayerExchanger(TwinModel.exchange_global_model), DittoServer
    else:
        logic = MrMtlClientLogic(engine.from_module(CifarNet(dtype=torch.float32)),
                                 engine.masked_cross_entropy, lam=SWEEP_LAM, adaptive=True)
        exchanger, server_cls = KeepLocalExchanger(), MrMtlServer
    sim = FederatedSimulation(
        logic=logic, tx=optim.sgd(0.05), strategy=FedAvgWithAdaptiveConstraint(),
        datasets=sweep_partition("even", DP_CLIENTS), batch_size=BATCH,
        metrics=MetricManager((efficient.accuracy(),)), local_steps=LOCAL_STEPS,
        exchanger=exchanger, seed=0, device="cuda")
    server = server_cls(sim)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    dp.reset_launch_counts()
    server.fit(1)
    torch.cuda.synchronize()
    t0 = time.time()
    hist = server.fit(1)
    torch.cuda.synchronize()
    warm = time.time() - t0
    for r in hist:
        values = [*r.fit_losses.values(), *r.eval_losses.values()]
        if not all(np.isfinite(v) for v in values):
            fail(f"{kind}_cifar_cnn round {r.round}: non-finite losses {r.fit_losses}")
    out = {"phase": f"{kind}_cifar_cnn", "clients": DP_CLIENTS, "rounds": len(hist),
           "fit_losses": [r.fit_losses for r in hist],
           "eval_losses": [r.eval_losses["checkpoint"] for r in hist],
           "drift_penalty_weight": float(sim.server_state.drift_penalty_weight),
           "warm_round_s": warm,
           "peak_gib_above_start": (torch.cuda.max_memory_allocated() - base) / 2**30,
           "launches": dict(dp.LAUNCHES), **twin_check(sim, kind)}
    if any(out["launches"].values()):
        fail(f"{kind}_cifar_cnn launched DP kernels: {out['launches']}")
    del sim, server
    torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def launches_per_cell(dp):
    """Within the block, every sweep cell's dispatch records the K1/K2
    launches it made, in dispatch order, into the yielded list (the
    runner's cell program wrapped; the launches are counted on the host as
    they are made, so a pack's back-to-back dispatches part exactly)."""
    from fl4health_tpu_torch.sweep.runner import SweepRunner

    per_cell, build = [], SweepRunner._build_cell_program

    def counted(self, sim, hoisted):
        cell_fn = build(self, sim, hoisted)

        def cell(inputs):
            before = dict(dp.LAUNCHES)
            out = cell_fn(inputs)
            per_cell.append({k: dp.LAUNCHES[k] - before[k] for k in before})
            return out

        return cell

    SweepRunner._build_cell_program = counted
    try:
        yield per_cell
    finally:
        SweepRunner._build_cell_program = build


def check_cell_launches(per_cell: list, n_cells: int, what: str) -> None:
    """5 K1 and 40 K2 launches a round in every one of ``n_cells`` cells."""
    want = dp_launches(SWEEP_ROUNDS)
    if len(per_cell) != n_cells or any(c != want for c in per_cell):
        fail(f"{what}: per-cell launches {per_cell}, expected {n_cells} x {want}")


def sweep_dp_cifar_cnn(dp) -> dict:
    """Phase 36, deterministic flags: the 24-cell DP grid (``sweep_spec``)
    through ``run_sweep`` with a completion ledger, its checks (finite
    cells, JAX's groups and buckets, no run-time compile, 5 K1 and 40 K2 a
    round, counted around each cell's dispatch), four unpadded cells (one a group, an uneven one
    among them) bit-equal to their standalone chunked ``fit`` and a padded
    48-client cell within 5e-4 of its own (R11: above 32 clients the
    aggregate's windows regroup), one group with ``pack=False`` bit-equal to
    its packed run, the ledger's rerun restoring every cell with no launch,
    the CPU tests' tiny grid on the card against the CPU, then Ditto and
    MR-MTL at full width."""
    from fl4health_tpu_torch.sweep import run_sweep

    t_phase = time.time()
    card = card_line()
    ledger = os.path.join(ckpt_dir("sweep"), "ledger.jsonl")
    spec = sweep_spec()
    for name in ("even", "uneven"):  # the draws belong to set-up, not to the grid
        sweep_partition(name, DP_CLIENTS)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    dp.reset_launch_counts()
    t0 = time.time()
    with launches_per_cell(dp) as per_cell:
        res = run_sweep(spec, ledger_path=ledger)
    torch.cuda.synchronize()
    grid_wall = time.time() - t0
    launches = dict(dp.LAUNCHES)
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    cells = {r.cell.label(): r for r in res.cells}
    bad = [k for k, r in cells.items()
           if not all(np.isfinite(v) for v in r.fit_losses + r.eval_losses)]
    if bad:
        fail(f"sweep: non-finite cells {bad}")
    shape = (len(res.plan.groups), len(res.cells), res.plan.buckets, res.programs_compiled)
    if shape != (4, 24, [DP_CLIENTS], 0):
        fail(f"sweep: (groups, cells, buckets, programs_compiled) {shape}")
    if launches != dp_launches(SWEEP_ROUNDS * len(res.cells)):
        fail(f"sweep: launches {launches} over 24 cells, expected "
             f"{dp_launches(SWEEP_ROUNDS * len(res.cells))}")
    check_cell_launches(per_cell, len(res.cells), "sweep")
    # one unpadded cell a group (two even, two uneven), bit for bit; and a
    # padded one
    by = lambda s, c, p, n, lr=None: next(  # noqa: E731
        r.cell for r in res.cells if (r.cell.strategy, r.cell.client, r.cell.partitioner,
                                      r.cell.cohort) == (s, c, p, n)
        and (lr is None or r.cell.scalar_dict.get("server_lr") == lr))
    full, part = SWEEP_COHORTS[1], SWEEP_COHORTS[0]
    exact = [by("fedavg", "dp", "even", full), by("fedavg", "dp_mrmtl", "uneven", full),
             by("fedadam", "dp", "uneven", full, SWEEP_LRS[1]),
             by("fedadam", "dp_mrmtl", "even", full, SWEEP_LRS[0])]
    padded = by("fedadam", "dp", "uneven", part, SWEEP_LRS[0])
    arms = {}
    for cell in [*exact, padded]:
        ref = sweep_standalone(spec, cell, dp)
        got = cells[cell.label()]
        diff = float(np.max(np.abs(np.subtract(got.fit_losses + got.eval_losses,
                                               ref["fit"] + ref["eval"]))))
        equal = got.fit_losses == ref["fit"] and got.eval_losses == ref["eval"]
        arms[cell.label()] = {"bit_equal": equal, "max_abs_diff": diff,
                              "wall_s": ref["wall_s"], "launches": ref["launches"]}
        if ref["launches"] != dp_launches(SWEEP_ROUNDS):
            fail(f"sweep standalone {cell.label()}: launches {ref['launches']}")
        if cell is padded:
            if not diff <= 5e-4:
                fail(f"sweep padded cell {cell.label()}: {diff} from its standalone run")
        elif not equal:
            fail(f"sweep cell {cell.label()} differs from its standalone chunked fit: "
                 f"{got.fit_losses} {got.eval_losses} against {ref}")
    # one group sequentially (pack=False) against its packed run
    group = dict(strategies={"fedavg": spec.strategies["fedavg"]},
                 clients={"dp_mrmtl": spec.clients["dp_mrmtl"]})
    dp.reset_launch_counts()
    t0 = time.time()
    with launches_per_cell(dp) as seq_per_cell:
        seq = run_sweep(sweep_spec(pack=False, **group))
    torch.cuda.synchronize()
    seq_wall, seq_launches = time.time() - t0, dict(dp.LAUNCHES)
    check_cell_launches(seq_per_cell, len(seq.cells), "sweep pack=False")
    for r in seq.cells:
        p = cells[r.cell.label()]
        if (r.fit_losses, r.eval_losses) != (p.fit_losses, p.eval_losses):
            fail(f"sweep: {r.cell.label()} sequential {r.eval_losses} packed {p.eval_losses}")
    if seq_launches != dp_launches(SWEEP_ROUNDS * len(seq.cells)):
        fail(f"sweep pack=False: launches {seq_launches} over {len(seq.cells)} cells")
    # the ledger's rerun restores every cell and launches nothing
    dp.reset_launch_counts()
    again = run_sweep(spec, ledger_path=ledger)
    torch.cuda.synchronize()
    rerun = (again.resumed_cells, dict(dp.LAUNCHES))
    if rerun != (24, {"dp_sq_norms": 0, "dp_scaled_sum": 0}) or [
            (r.fit_losses, r.eval_losses) for r in again.cells] != [
            (r.fit_losses, r.eval_losses) for r in res.cells]:
        fail(f"sweep ledger rerun: resumed {rerun[0]}, launches {rerun[1]}")
    drop_dirs(os.path.dirname(ledger))
    tiny = tiny_sweep_parity()
    ditto = personalized_cifar_cnn("ditto", dp)
    mrmtl = personalized_cifar_cnn("mrmtl", dp)
    out = {"phase": "sweep_dp_cifar_cnn", "card": card, **res.bench_block(),
           "grid_wall_s": grid_wall, "rounds": SWEEP_ROUNDS,
           "peak_gib_above_start": peak, "launches": launches,
           "launches_per_cell": per_cell[0],
           "cells_detail": [{"label": r.cell.label(), "group": r.group, "wall_s": r.wall_s,
                             "steps_per_s": r.steps_per_s,
                             "final_eval_loss": r.final_eval_loss} for r in res.cells],
           "standalone_arms": arms,
           "pack_false": {"cells": len(seq.cells), "wall_s": seq_wall,
                          "launches": seq_launches, "bit_equal": True},
           "ledger_rerun": {"resumed_cells": rerun[0], "launches": rerun[1]},
           "tiny_card_vs_cpu": tiny, "ditto_cifar_cnn": ditto, "mrmtl_cifar_cnn": mrmtl,
           "phase_s": time.time() - t_phase}
    print(json.dumps(out))
    return out


# -- the split-model personalisation slice ---------------------------------------
PFL_KINDS = ("apfl", "fenda", "constrained_fenda", "perfcl", "fenda_ditto", "fedrep",
             "fedper", "gpfl", "ensemble", "simclr", "ditto_moon")
PFL_TINY_ROUNDS = 3  # the CPU tests' fixture (tests/torch_pfl_sims.py)
PFL_TINY_TOL = 5e-4


def pfl_blocks(tiny: bool) -> dict:
    """The arms' blocks: the CPU tests' (8 features, 3 classes: ``Mlp(16)``,
    ``DenseFeatures(12)``, projections of 8), or the DP path's width
    (``CifarNet`` in f32, ``ConvFeatures((32, 64))`` on 32x32x3: 4096
    features, 10 classes, projections of 128, GPFL's feature_dim 64)."""
    from fl4health_tpu_torch.models import bases
    from fl4health_tpu_torch.models.cnn import CifarNet, Mlp

    if tiny:
        return dict(net=lambda: Mlp(8, (16,), 3), feats=lambda: bases.DenseFeatures(8, (12,)),
                    width=12, classes=3, proj=8, gpfl_dim=12)
    return dict(net=lambda: CifarNet(dtype=torch.float32),
                feats=lambda: bases.ConvFeatures((32, 64), (32, 32, 3)),
                width=4096, classes=10, proj=128, gpfl_dim=64)


def pfl_arm(kind: str, tiny: bool) -> tuple:
    """-> (logic, exchanger, ssl) of one arm: APFL (alpha 0.5, adaptive),
    FENDA, Constrained FENDA (cos 0.5, contrastive 0.5), PerFCL (0.5/0.5),
    FENDA+Ditto (lam 1), FedRep (2 head steps a round), FedPer, GPFL (lam
    and mu 0.01), a 2-member ensemble, FedSimCLR, and make_it_personal(MOON,
    DITTO)."""
    from fl4health_tpu_torch.clients import engine
    from fl4health_tpu_torch.clients.apfl import ApflClientLogic, apfl_model_def
    from fl4health_tpu_torch.clients.ensemble import EnsembleClientLogic
    from fl4health_tpu_torch.clients.fedrep import FedPerClientLogic, FedRepClientLogic
    from fl4health_tpu_torch.clients.fedsimclr import FedSimClrClientLogic
    from fl4health_tpu_torch.clients.fenda import (ConstrainedFendaClientLogic,
                                                   FendaClientLogic, FendaDittoClientLogic,
                                                   PerFclClientLogic)
    from fl4health_tpu_torch.clients.gpfl import GpflClientLogic, gpfl_model_def
    from fl4health_tpu_torch.clients.moon import MoonClientLogic
    from fl4health_tpu_torch.clients.personalized import (PersonalizedMode,
                                                          exchange_global_subtree,
                                                          make_it_personal)
    from fl4health_tpu_torch.exchange.exchanger import FixedLayerExchanger
    from fl4health_tpu_torch.models import bases

    b = pfl_blocks(tiny)
    ce, wired = engine.masked_cross_entropy, engine.from_module

    def fenda():
        return bases.FendaModel(b["feats"](), b["feats"](), bases.HeadModule(
            bases.DenseHead(2 * b["width"], b["classes"])))

    def split():
        return wired(bases.FedRepModel(b["feats"](), bases.DenseHead(b["width"], b["classes"])))

    fenda_wire = FixedLayerExchanger(bases.ParallelSplitModel.exchange_global_extractor)
    split_wire = FixedLayerExchanger(bases.SequentiallySplitModel.exchange_features_only)
    if kind == "apfl":
        return (ApflClientLogic(apfl_model_def(bases.ApflModule(b["net"](), b["net"]())), ce,
                                alpha=0.5, adaptive_alpha=True),
                FixedLayerExchanger(bases.ApflModule.exchange_global_model), False)
    if kind == "fenda":
        return FendaClientLogic(wired(fenda()), ce), fenda_wire, False
    if kind == "constrained_fenda":
        return (ConstrainedFendaClientLogic(wired(fenda()), ce, cos_sim_loss_weight=0.5,
                                            contrastive_loss_weight=0.5), fenda_wire, False)
    if kind == "perfcl":
        return (PerFclClientLogic(wired(fenda()), ce, global_feature_loss_weight=0.5,
                                  local_feature_loss_weight=0.5), fenda_wire, False)
    if kind == "fenda_ditto":
        return (FendaDittoClientLogic(wired(bases.TwinModel(fenda(), fenda())), ce, lam=1.0),
                FixedLayerExchanger(bases.TwinModel.exchange_global_model), False)
    if kind == "fedrep":
        return FedRepClientLogic(split(), ce, head_steps=2), split_wire, False
    if kind == "fedper":
        return FedPerClientLogic(split(), ce), split_wire, False
    if kind == "gpfl":
        return (GpflClientLogic(gpfl_model_def(bases.GpflModel(b["feats"](), b["classes"],
                                                               b["gpfl_dim"])), ce,
                                n_classes=b["classes"], lam=0.01, mu=0.01),
                FixedLayerExchanger(bases.GpflModel.exchange_shared), False)
    if kind == "ensemble":
        return (EnsembleClientLogic(wired(bases.EnsembleModel([b["net"](), b["net"]()])), ce,
                                    n_members=2), None, False)
    if kind == "simclr":
        return (FedSimClrClientLogic(wired(bases.FedSimClrModel(
                    b["feats"](), bases.DenseHead(b["width"], b["proj"]))), temperature=0.5),
                None, True)
    if kind == "ditto_moon":
        moon = MoonClientLogic(wired(bases.MoonModel(b["feats"](), bases.DenseHead(
            b["width"], b["classes"]))), ce, contrastive_weight=1.0, buffer_len=1)
        return (make_it_personal(moon, PersonalizedMode.DITTO),
                FixedLayerExchanger(exchange_global_subtree), False)
    raise ValueError(kind)


def pfl_datasets(tiny: bool, ssl: bool, device: str) -> list:
    """The tiny fixture's 3 clients (``synthetic_classification(PRNGKey(i),
    48, (8,), 3)``, 32 train and 16 val rows; FedSimCLR's second view the
    first plus 0.05 of ``normal(PRNGKey(100 + i))``) drawn on ``device``, or
    the 64 ``dp_cifar_cnn`` clients (``sweep_partition("even", 64)``;
    FedSimCLR's second view the horizontal flip of the first)."""
    from fl4health_tpu_torch import rng
    from fl4health_tpu_torch.datasets.synthetic import synthetic_classification
    from fl4health_tpu_torch.server.simulation import ClientDataset

    if not tiny:
        data = sweep_partition("even", DP_CLIENTS)
        if not ssl:
            return data
        flip = lambda a: torch.as_tensor(a).flip(2)  # noqa: E731  NHWC: the width axis
        return [ClientDataset(d.x_train, flip(d.x_train), d.x_val, flip(d.x_val))
                for d in data]
    out = []
    for i in range(3):
        x, y = synthetic_classification(rng.PRNGKey(i, device), 48, (8,), 3)
        if ssl:
            y = x + 0.05 * rng.normal(rng.PRNGKey(100 + i, device), tuple(x.shape))
        x, y = x.cpu(), y.cpu()
        out.append(ClientDataset(x[:32], y[:32], x[32:], y[32:]))
    return out


def pfl_sim(kind: str, tiny: bool, device: str, mode: str = "pipelined"):
    """An arm's simulation: FedAvg, SGD(0.05), f32; the tiny fixture's batch
    8, one local epoch, seed 3, or the DP path's batch 32, 5 local steps,
    seed 0."""
    from fl4health_tpu_torch import optim
    from fl4health_tpu_torch.metrics import efficient
    from fl4health_tpu_torch.metrics.base import MetricManager
    from fl4health_tpu_torch.server.simulation import FederatedSimulation
    from fl4health_tpu_torch.strategies.fedavg import FedAvg

    logic, exchanger, ssl = pfl_arm(kind, tiny)
    steps = dict(local_epochs=1) if tiny else dict(local_steps=LOCAL_STEPS)
    return FederatedSimulation(
        logic=logic, tx=optim.sgd(0.05), strategy=FedAvg(),
        datasets=pfl_datasets(tiny, ssl, device), batch_size=8 if tiny else BATCH,
        metrics=MetricManager(() if ssl else (efficient.accuracy(),)), exchanger=exchanger,
        seed=3 if tiny else 0, execution_mode=mode, device=device, **steps)


def tiny_pfl_parity() -> dict:
    """Every arm's tiny fixture (the CPU tests') on the card and on the CPU,
    3 rounds: each round's fit and eval losses (every key) within 5e-4."""
    err = {}
    for kind in PFL_KINDS:
        card, cpu = (pfl_sim(kind, True, d).fit(PFL_TINY_ROUNDS) for d in ("cuda", "cpu"))
        worst = 0.0
        for a, b in zip(card, cpu, strict=True):
            for field in ("fit_losses", "eval_losses"):
                x, y = getattr(a, field), getattr(b, field)
                if set(x) != set(y) or not all(np.isfinite(v) for v in x.values()):
                    fail(f"tiny {kind} round {a.round}: {field} card {x}, CPU {y}")
                worst = max(worst, *(abs(x[k] - y[k]) for k in x))
        err[kind] = worst
        if not worst <= PFL_TINY_TOL:
            fail(f"tiny {kind}: card-vs-CPU max abs err {worst} > {PFL_TINY_TOL}")
    out = {"phase": "tiny_pfl_parity", "rounds": PFL_TINY_ROUNDS, "max_abs_err": err}
    print(json.dumps(out))
    return out


def client_spread(params: dict, prefix: str) -> float:
    """The largest difference over the clients of the leaves under
    ``prefix`` (0: every client holds the same)."""
    keys = [k for k in params if k.startswith(prefix)]
    if not keys:
        fail(f"no params under {prefix}")
    rows = torch.cat([params[k].reshape(params[k].shape[0], -1) for k in keys], 1)
    return float((rows - rows[:1]).abs().max())


def pfl_checks(kind: str, sim) -> dict:
    """After the warm round (the clients' states after eval: the pulled
    globals beside the kept private leaves): each arm's own check."""
    hist, params = sim.history, sim.client_states.params
    fit = [r.fit_losses for r in hist]
    ev = [r.eval_losses["checkpoint"] for r in hist]
    shared, private = {
        "apfl": ("global_model/", "local_model/"),
        "fenda": ("second_feature_extractor/", "first_feature_extractor/"),
        "constrained_fenda": ("second_feature_extractor/", "first_feature_extractor/"),
        "perfcl": ("second_feature_extractor/", "first_feature_extractor/"),
        "fenda_ditto": ("global_model/", "personal_model/"),
        "fedrep": ("features_module/", "head_module/"),
        "fedper": ("features_module/", "head_module/"),
        "gpfl": ("gce/embedding", "head/"),
        "ensemble": (None, None), "simclr": (None, None),
        "ditto_moon": ("global_model/", "personal_model/"),
    }[kind]
    out = {}
    if shared is not None:
        out = {"shared_spread": client_spread(params, shared),
               "private_spread": client_spread(params, private)}
        if out["shared_spread"] != 0.0 or not out["private_spread"] > 0.0:
            fail(f"{kind}_cifar_cnn: {shared} spread {out['shared_spread']} (want 0), "
                 f"{private} spread {out['private_spread']} (want > 0)")
    if kind == "apfl":
        alpha = sim.client_states.extra.alpha
        out["alpha"] = [float(alpha.min()), float(alpha.max())]
        if not (bool((alpha != 0.5).all()) and float(alpha.max() - alpha.min()) > 0.0):
            fail(f"apfl_cifar_cnn: alphas {out['alpha']} did not all leave 0.5 and part")
    term = {"constrained_fenda": "contrastive", "perfcl": "global_contrastive",
            "ditto_moon": "personal_contrastive"}.get(kind)
    if term is not None:
        out[term] = [f[term] for f in fit]
        if fit[0][term] != 0.0 or fit[1][term] == 0.0:
            fail(f"{kind}_cifar_cnn: {term} {out[term]} (want 0, then non-zero)")
    if kind == "simclr":
        # the NT-Xent the clients minimise falls round on round; the
        # held-out pairs' moves by noise over two rounds at 64 clients
        # (the card's and the CPU's alike) and falls later
        out["train_ntxent"] = [f["backward"] for f in fit]
        if not fit[1]["backward"] < fit[0]["backward"]:
            fail(f"simclr_cifar_cnn: the training NT-Xent {out['train_ntxent']} did not fall")
    return out


def pfl_cifar_cnn(fa, dp) -> dict:
    """Phase 37: the tiny fixture card against CPU, then every arm at the DP
    path's width (the 64 ``dp_cifar_cnn`` clients, batch 32, 5 SGD(0.05)
    steps, f32, FedAvg), pipelined: a cold round, then a warm one timed,
    the peak above the arm's start; ``perfcl`` also chunked, bit for bit
    the pipelined run (cuDNN deterministic). K1-K5 launch 0 times over
    the phase, as in JAX."""
    counters = lambda: [dict(c) for c in (fa.LAUNCHES, fa.WGMMA_LAUNCHES, dp.LAUNCHES)]  # noqa: E731
    fa.reset_launch_counts()
    dp.reset_launch_counts()
    t_phase = time.time()
    tiny = tiny_pfl_parity()
    arms = {}
    for kind in PFL_KINDS:
        sim = pfl_sim(kind, False, "cuda")
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        sim.fit(1)
        torch.cuda.synchronize()
        cold = time.time() - t0
        t0 = time.time()
        sim.fit(1)
        torch.cuda.synchronize()
        warm = time.time() - t0
        peak = (torch.cuda.max_memory_allocated() - base) / 1e9
        for r in sim.history:
            values = [*r.fit_losses.values(), *r.eval_losses.values()]
            if not all(np.isfinite(v) for v in values):
                fail(f"{kind}_cifar_cnn round {r.round}: non-finite losses {r.fit_losses} "
                     f"{r.eval_losses}")
        arm = {"phase": f"{kind}_cifar_cnn", "clients": DP_CLIENTS, "cold_round_s": cold,
               "warm_round_s": warm, "peak_gb_above_start": peak,
               "fit_losses": [r.fit_losses for r in sim.history],
               "eval_losses": [r.eval_losses["checkpoint"] for r in sim.history],
               **pfl_checks(kind, sim)}
        if kind == "perfcl":
            chunked = pfl_sim(kind, False, "cuda", mode="chunked")
            chunked.fit(1)
            chunked.fit(1)
            arm["chunked_equal"] = history_equal(sim, chunked) and states_equal(sim, chunked)
            if not arm["chunked_equal"]:
                fail("perfcl_cifar_cnn: the chunked route parts from the pipelined route")
            del chunked
        print(json.dumps(arm))
        arms[kind] = arm
        del sim
        torch.cuda.empty_cache()
    launches = counters()
    if any(v for c in launches for v in c.values()):
        fail(f"phase 37 launched K1-K5: {launches}")
    out = {"phase": "pfl_cifar_cnn", "arms": len(arms), "wall_s": time.time() - t_phase,
           "tiny_max_abs_err": max(tiny["max_abs_err"].values()),
           "warm_round_s": {k: a["warm_round_s"] for k, a in arms.items()},
           "peak_gb_above_start": {k: a["peak_gb_above_start"] for k, a in arms.items()},
           "launches": launches}
    print(card_line())
    print(json.dumps(out))
    return out


# -- the mesh slice: device meshes on torch.distributed -----------------------
#
# The card's machine has one H100, and two NCCL ranks cannot share a device,
# so the mesh runs as a one-rank NCCL world: every collective of the sharded
# programs is called through NCCL (all-reduce of the aggregate, the
# gathers of the per-client records, the ZeRO-1 update's all-gather, the
# ring's scatter and gather) and must leave every bit as the unsharded run
# leaves it.

def nccl_world():
    """A one-rank NCCL world from a FileStore in a temporary directory (no
    network); returns the directory to remove."""
    import tempfile

    import torch.distributed as dist

    root = tempfile.mkdtemp(prefix="chip_smoke_nccl_")
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.FileStore(os.path.join(root, "store"), 1),
                            rank=0, world_size=1, device_id=torch.device("cuda", 0))
    return root


def timed_fit(sim, rounds: int, counters) -> dict:
    """``sim.fit(rounds)`` from zeroed launch counts and peak: the synchronised
    wall, the peak device memory above what was allocated at its start (the
    arm's other runs and earlier phases' tensors stay out) and the launches."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    for c in counters:
        c.reset_launch_counts()
    t0 = time.time()
    sim.fit(rounds)
    torch.cuda.synchronize()
    return {"wall_s": time.time() - t0,
            "peak_gib_above_start": (torch.cuda.max_memory_allocated() - start) / 2**30,
            "launches": {k: v for c in counters for k, v in c.LAUNCHES.items()}}


def mesh_arm(name: str, build, counters, expected: dict, modes=("pipelined",),
             rounds: int = 2, warm: bool = True) -> dict:
    """One arm: the unsharded run and the sharded one (per route) of the same
    recipe, ``rounds`` rounds (or async events) each from the same init, bit
    for bit; then (``warm``) warm rounds of each in turns, synchronised, and
    each run's peak device memory. Launches are counted over each run."""
    out = {"arm": name, "rounds": rounds}
    ref = build(None, modes[0])
    init = {k: v.clone() for k, v in ref.global_params.items()}
    runs = {"unsharded": (ref, timed_fit(ref, rounds, counters))}
    for mode in modes:
        sim = build("mesh", mode)
        if not all(torch.equal(sim.global_params[k], v) for k, v in init.items()):
            fail(f"{name}: the sharded run's init differs from the unsharded one's")
        runs[f"mesh_{mode}"] = (sim, timed_fit(sim, rounds, counters))
    for key, (sim, stats) in runs.items():
        hist = [(r.fit_losses, r.eval_losses, r.eval_metrics) for r in sim.history]
        if not all(np.isfinite(v) for h in hist for d in h for v in d.values()):
            fail(f"{name} {key}: non-finite records {hist}")
        if stats["launches"] != expected:
            fail(f"{name} {key}: launches {stats['launches']}, expected {expected}")
        if key != "unsharded":
            if not history_equal(sim, ref):
                fail(f"{name} {key}: records differ from the unsharded run's")
            if not all(torch.equal(sim.global_params[k], v)
                       for k, v in ref.global_params.items()):
                fail(f"{name} {key}: global params differ from the unsharded run's")
    for key, (sim, stats) in runs.items():
        out[key] = {**stats, "warm_round_s": [],
                    "fit_losses": [r.fit_losses["backward"] for r in sim.history]}
    # then warm rounds in turns (unsharded, sharded..., sharded..., unsharded)
    for key in ([*runs, *reversed(runs)] if warm else []):
        torch.cuda.synchronize()
        t0 = time.time()
        runs[key][0].fit(1)
        torch.cuda.synchronize()
        out[key]["warm_round_s"].append(time.time() - t0)
    for key in runs:
        print(json.dumps({"mesh_arm": name, "run": key, **out[key]}))
    runs.clear()
    torch.cuda.empty_cache()
    return out


def mesh_slice(fa, dp) -> dict:
    """Phase 38: ``mesh_dp_cifar_cnn`` (MeshConfig() on both routes),
    ``mesh_zero1_bert_lora_fedopt`` (MeshConfig(zero1=True)) and
    ``ring_transformer_long`` (the flash ring over a one-rank seq axis),
    each against its unsharded run in the same call."""
    import functools

    import torch.distributed as dist

    from fl4health_tpu_torch.kernels.flash_attention import flash_attention
    from fl4health_tpu_torch.parallel.mesh import make_mesh
    from fl4health_tpu_torch.parallel.program import MeshConfig
    from fl4health_tpu_torch.parallel.ring_attention import ring_flash_attention
    from fl4health_tpu_torch.parallel.zero import ZeroShardedOptimizer

    root = nccl_world()
    try:
        dp_data = image_datasets(DP_CLIENTS, DP_TRAIN, DP_VAL, (32, 32, 3))

        def dp_build(mesh, mode):
            return build_dp_sim(dp_data, torch.bfloat16, "cuda", DP_SIGMA, seed=0,
                                execution_mode=mode,
                                mesh=MeshConfig() if mesh else None)

        steps = DP_ROUNDS * LOCAL_STEPS
        dp_arm = mesh_arm("mesh_dp_cifar_cnn", dp_build, [dp],
                          {"dp_sq_norms": steps, "dp_scaled_sum": steps * len(CIFAR_LEAVES)},
                          modes=("pipelined", "chunked"))

        bert_data = bert_datasets(BERT_CFG, BERT_CLIENTS, BERT_TRAIN + BERT_VAL, BERT_TRAIN)

        def bert_build(mesh, mode):
            sim = build_bert_sim(BERT_CFG, bert_data, torch.bfloat16, "cuda", 0,
                                 flash_attention, False, BERT_LR, BATCH, LOCAL_STEPS,
                                 execution_mode=mode,
                                 mesh=MeshConfig(zero1=True) if mesh else None)
            if mesh and not isinstance(sim.strategy.tx, ZeroShardedOptimizer):
                fail("mesh_zero1_bert_lora_fedopt: the server optimizer is not ZeRO-1")
            return sim

        layers = BERT_CFG["n_layers"]
        bert_arm = mesh_arm("mesh_zero1_bert_lora_fedopt", bert_build, [fa],
                            {"flash_fwd": 2 * layers * (LOCAL_STEPS + 1),
                             "flash_bwd_dq": 2 * layers * LOCAL_STEPS,
                             "flash_bwd_dkv": 2 * layers * LOCAL_STEPS})

        cfg = dict(vocab_size=8192, n_classes=4, d_model=512, n_heads=8, n_layers=4,
                   d_ff=2048, max_len=T)
        text = text_datasets(8192, T, BATCH * LOCAL_STEPS + 16, BATCH * LOCAL_STEPS)
        ring = functools.partial(ring_flash_attention, mesh=make_mesh((1,), ("seq",)))

        def ring_build(mesh, mode):
            return build_sim(cfg, text, torch.bfloat16, "cuda", seed=0,
                             attention_fn=ring if mesh else flash_attention,
                             execution_mode=mode)

        ring_arm = mesh_arm("ring_transformer_long", ring_build, [fa],
                            {"flash_fwd": 2 * (LOCAL_STEPS * 4 * 2 + 4),
                             "flash_bwd_dq": 2 * LOCAL_STEPS * 4,
                             "flash_bwd_dkv": 2 * LOCAL_STEPS * 4})
    finally:
        dist.destroy_process_group()
        drop_dirs(root)
    return {"dp": dp_arm, "bert": bert_arm, "ring": ring_arm}


# -- the model-state slice: buffered async and the admin plane under a mesh,
# TrainState.model_state with FedPM's masked models and FedBN's statistics ----

FEDPM_ROUNDS, FEDBN_ROUNDS = 3, 2
FEDPM_TINY_TOL = 5e-4


def mesh_async_dp_cifar_cnn(dp) -> dict:
    """``mesh_async_dp_cifar_cnn``: ``async_dp_cifar_cnn``'s recipe (6
    events, buffer 32, clients 0 and 1 at 5x) unsharded and under a
    one-rank NCCL ``MeshConfig()`` on both async routes: bit for bit, 35 K1
    and 280 K2 launches each (7 waves of 5 steps)."""
    from fl4health_tpu_torch.parallel.program import MeshConfig

    data = image_datasets(DP_CLIENTS, DP_TRAIN, DP_VAL, (32, 32, 3))
    cfg, faults = async_recipe()

    def build(mesh, mode):
        return build_dp_sim(data, torch.bfloat16, "cuda", DP_SIGMA, seed=0,
                            execution_mode=mode, async_config=cfg, fault_plan=faults,
                            mesh=MeshConfig() if mesh else None)

    steps = (ASYNC_EVENTS + 1) * LOCAL_STEPS
    return mesh_arm("mesh_async_dp_cifar_cnn", build, [dp],
                    {"dp_sq_norms": steps, "dp_scaled_sum": steps * len(CIFAR_LEAVES)},
                    modes=("pipelined", "chunked"), rounds=ASYNC_EVENTS, warm=False)


def mesh_ops_dp_cifar_cnn(dp) -> dict:
    """``mesh_ops_dp_cifar_cnn``: the DP path under ``fed_adam(0.05)`` with
    an armed admin plane, 2 pipelined rounds; round 2's data provider POSTs
    ``server_lr`` 0.02 to rank 0's endpoint before round 2's boundary. The
    one-rank mesh's run (the retune broadcast over NCCL) against the
    unsharded run with the same POST: bit for bit, 10 K1 and 80 K2 launches
    each, both journals at round 2."""
    from fl4health_tpu_torch.observability import MetricsRegistry, Observability, Tracer
    from fl4health_tpu_torch.parallel.program import MeshConfig
    from fl4health_tpu_torch.strategies.fedopt import fed_adam

    data = image_datasets(DP_CLIENTS, DP_TRAIN, DP_VAL, (32, 32, 3))
    retune = {"server_lr": 0.02}
    out, sims = {"arm": "mesh_ops_dp_cifar_cnn", "rounds": OPS_ROUNDS, "retune": retune}, {}
    for name, mesh in (("unsharded", None), ("mesh", MeshConfig())):
        obs = Observability(enabled=True, registry=MetricsRegistry(), tracer=Tracer(),
                            admin_token=OPS_TOKEN, http_port=0, introspection=False)
        posted = {}

        def provider(rnd, obs=obs, posted=posted):
            if rnd == 2 and "resp" not in posted:
                posted["resp"] = post_json(obs.scrape_url + "/admin/scalars", retune,
                                           OPS_TOKEN)
            return None

        sim = build_dp_sim(data, torch.bfloat16, "cuda", DP_SIGMA, seed=0,
                           strategy=fed_adam(lr=0.05), observability=obs,
                           train_data_provider=provider, execution_mode="pipelined",
                           mesh=mesh)
        stats = timed_fit(sim, OPS_ROUNDS, [dp])
        journal = [(j["round"], j["scalars"]) for j in obs.admin.journal()]
        lr = float(sim.server_state.opt_state.hyperparams["learning_rate"])
        if (posted.get("resp", (None,))[0] != 200 or journal != [(2, retune)]
                or lr != float(np.float32(retune["server_lr"]))):
            fail(f"mesh_ops_dp_cifar_cnn {name}: POST {posted.get('resp')}, journal "
                 f"{journal}, lr {lr}")
        if stats["launches"] != dp_launches(OPS_ROUNDS):
            fail(f"mesh_ops_dp_cifar_cnn {name}: launches {stats['launches']}, expected "
                 f"{dp_launches(OPS_ROUNDS)}")
        sims[name] = sim
        out[name] = {**stats, "journal": journal, "server_lr_leaf": lr,
                     "fit_losses": [r.fit_losses["backward"] for r in sim.history]}
    if not trajectory_equal(sims["unsharded"], sims["mesh"]):
        fail("mesh_ops_dp_cifar_cnn: the mesh run differs from the unsharded run")
    out["bit_equal"] = True
    print(json.dumps(out))
    del sims
    torch.cuda.empty_cache()
    return out


def fedpm_sim(data, device: str, mode: str, in_features: int, hidden: tuple,
              n_out: int, batch: int, seed: int, local_steps=None, local_epochs=None,
              init=None):
    """FedPM over ``MaskedMlp(hidden, n_out)``: Adam(0.01) on the scores,
    ``FedPm(reset_frequency=2)``; ``init`` (params, frozen state) installed
    where given."""
    import dataclasses

    from fl4health_tpu_torch import optim
    from fl4health_tpu_torch.clients import engine
    from fl4health_tpu_torch.clients.fedpm import FedPmClientLogic
    from fl4health_tpu_torch.metrics import efficient
    from fl4health_tpu_torch.metrics.base import MetricManager
    from fl4health_tpu_torch.models.masked import MaskedMlp
    from fl4health_tpu_torch.server.simulation import FederatedSimulation
    from fl4health_tpu_torch.strategies.fedpm import FedPm

    logic = FedPmClientLogic(engine.from_module(MaskedMlp(in_features, hidden, n_out)),
                             engine.masked_cross_entropy)
    if init is not None:
        params, state = init
        logic.model = dataclasses.replace(
            logic.model, init=lambda g: {k: v.clone() for k, v in params.items()},
            init_state=lambda g: state)
    return FederatedSimulation(
        logic=logic, tx=optim.adam(0.01), strategy=FedPm(reset_frequency=2), datasets=data,
        batch_size=batch, metrics=MetricManager((efficient.accuracy(),)),
        local_steps=local_steps, local_epochs=local_epochs, seed=seed,
        execution_mode=mode, device=device)


class PacketRecorder:
    """Wraps a strategy's ``aggregate``: per round, whether every packet
    entry is 0 or 1, and the round's participating clients (the mask's
    sum), kept as device tensors and read after the run."""

    def __init__(self, sim):
        self.binary, self.participants = [], []
        inner = sim.strategy.aggregate

        def aggregate(server_state, results, round_idx):
            self.binary.append(torch.stack([((p == 0) | (p == 1)).all()
                                            for p in results.packets.values()]).all())
            self.participants.append(results.mask.sum())
            return inner(server_state, results, round_idx)

        sim.strategy.aggregate = aggregate


def tiny_fedpm_arrays() -> list:
    """tests/clients/test_fedpm_simclr.py's fixture: 2 clients of 24 train
    and 16 val rows of ``synthetic_classification(PRNGKey(i), 40, (8,), 3)``."""
    from fl4health_tpu_torch import rng
    from fl4health_tpu_torch.datasets.synthetic import synthetic_classification
    from fl4health_tpu_torch.server.simulation import ClientDataset

    out = []
    for i in range(2):
        x, y = synthetic_classification(rng.PRNGKey(i), 40, (8,), 3)
        out.append(ClientDataset(x[:24].numpy(), y[:24].numpy(), x[24:].numpy(),
                                 y[24:].numpy()))
    return out


def fedpm_mnist(fa, dp) -> dict:
    """``fedpm_mnist``: ``examples/fedpm_example``'s model, ``MaskedMlp(
    features=(64,), n_outputs=10)`` on 28x28x1 synthetic data, 64 clients,
    batch 32, 5 local steps, ``FedPm(reset_frequency=2)``, 3 rounds, the
    pipelined and chunked routes bit for bit; every packet binary, theta in
    [0, 1], ``alpha + beta - 2`` the participants summed since the last
    reset, element by element; no kernel launched; the warm round and the
    peak above start. Then the CPU test's tiny recipe card against CPU
    within 5e-4."""
    data = image_datasets(DP_CLIENTS, DP_TRAIN, DP_VAL, (28, 28, 1))
    out = {"phase": "fedpm_mnist", "clients": DP_CLIENTS, "rounds": FEDPM_ROUNDS}
    sims, recorders = {}, {}
    for mode in ("pipelined", "chunked"):
        sim = fedpm_sim(data, "cuda", mode, 28 * 28, (64,), 10, BATCH, seed=0,
                        local_steps=LOCAL_STEPS)
        recorders[mode] = PacketRecorder(sim)
        out[mode] = timed_fit(sim, FEDPM_ROUNDS, [fa, dp])
        sims[mode] = sim
        if any(out[mode]["launches"].values()):
            fail(f"fedpm_mnist {mode}: kernels launched {out[mode]['launches']}")
    if not (history_equal(*sims.values()) and states_equal(*sims.values())):
        fail("fedpm_mnist: the chunked route differs from the pipelined")
    sim, rec = sims["pipelined"], recorders["pipelined"]
    if not bool(torch.stack(rec.binary).all()):
        fail("fedpm_mnist: a packet entry is neither 0 nor 1")
    st = sim.server_state
    theta = torch.cat([v.reshape(-1) for v in st.params.values()])
    if float(theta.min()) < 0.0 or float(theta.max()) > 1.0:
        fail(f"fedpm_mnist: theta in [{float(theta.min())}, {float(theta.max())}]")
    since = int(st.rounds_since_reset)
    counted = sum(float(p) for p in rec.participants[len(rec.participants) - since:])
    for k, a in st.alpha.items():
        if not torch.equal(a + st.beta[k] - 2.0, torch.full_like(a, counted)):
            fail(f"fedpm_mnist: alpha + beta - 2 of {k} is not {counted} everywhere")
    for r in sim.history:
        if not all(np.isfinite(v) for v in (*r.fit_losses.values(), *r.eval_losses.values())):
            fail(f"fedpm_mnist round {r.round}: non-finite {r.fit_losses}")
    torch.cuda.synchronize()
    t0 = time.time()
    sim.fit(1)
    torch.cuda.synchronize()
    out.update({"routes_bit_equal": True, "rounds_since_reset": since,
                "alpha_beta_count": counted, "warm_round_s": time.time() - t0,
                "theta_range": [float(theta.min()), float(theta.max())],
                "fit_losses": [r.fit_losses["backward"] for r in sim.history],
                "eval_losses": [r.eval_losses["checkpoint"] for r in sim.history]})
    del sims, sim
    torch.cuda.empty_cache()
    # the tiny recipe, card against CPU from the same init
    tiny = tiny_fedpm_arrays()
    cpu = fedpm_sim(tiny, "cpu", "pipelined", 8, (16,), 3, 8, seed=5, local_epochs=1)
    init = ({k: v.clone() for k, v in cpu.global_params.items()},
            {c: {m: {k: v[0].clone() for k, v in leaves.items()}
                 for m, leaves in mods.items()}
             for c, mods in cpu.client_states.model_state.items()})
    cpu.fit(FEDPM_ROUNDS)
    card = fedpm_sim(tiny, "cuda", "pipelined", 8, (16,), 3, 8, seed=5, local_epochs=1,
                     init=init)
    card.fit(FEDPM_ROUNDS)
    for gr, cr in zip(card.history, cpu.history, strict=True):
        check(f"tiny fedpm eval loss r{gr.round}", torch.tensor(gr.eval_losses["checkpoint"]),
              torch.tensor(cr.eval_losses["checkpoint"]), FEDPM_TINY_TOL, 0)
    err = max(check(f"tiny fedpm theta {k}", card.server_state.params[k].cpu(),
                    cpu.server_state.params[k], FEDPM_TINY_TOL, 0)
              for k in cpu.server_state.params)
    out["tiny_max_theta_abs_err"] = err
    print(json.dumps(out))
    return out


class BnMlp(torch.nn.Module):
    """tests/clients/test_personalization.py's ``BnMlp``: Dense 16, flax's
    BatchNorm (its statistics the model state), relu, Dense."""

    def __init__(self, in_features: int, n_classes: int):
        from fl4health_tpu_torch.models.norm import BatchNorm
        from fl4health_tpu_torch.models.transformer import LoraDense

        super().__init__()
        self.Dense_0 = LoraDense(in_features, 16, dtype=None)
        self.BatchNorm_0 = BatchNorm(16)
        self.Dense_1 = LoraDense(16, n_classes, dtype=None)

    def init_params(self, generator):
        from fl4health_tpu_torch.models.cnn import _init_params

        return _init_params(self, generator)

    def init_state(self, generator):
        return {"batch_stats": {"BatchNorm_0": self.BatchNorm_0.init_stats()}}

    def forward(self, x, train=True, state=None):
        h, stats = self.BatchNorm_0(self.Dense_0(x), state["batch_stats"]["BatchNorm_0"],
                                    not train)
        return (({"prediction": self.Dense_1(torch.relu(h))}, {}),
                {"batch_stats": {"BatchNorm_0": stats}})


def fedbn_datasets(n_clients: int) -> list:
    """Client i's 32 train and 16 val rows of
    ``synthetic_classification(PRNGKey(i), 48, (8,), 3)`` (the CPU tests')."""
    from fl4health_tpu_torch import rng
    from fl4health_tpu_torch.datasets.synthetic import synthetic_classification
    from fl4health_tpu_torch.server.simulation import ClientDataset

    out = []
    for i in range(n_clients):
        x, y = synthetic_classification(rng.PRNGKey(i), 48, (8,), 3)
        out.append(ClientDataset(x[:32].numpy(), y[:32].numpy(), x[32:].numpy(),
                                 y[32:].numpy()))
    return out


def fedbn_sim(data, device: str, **sim_kw):
    from fl4health_tpu_torch import optim
    from fl4health_tpu_torch.clients import engine
    from fl4health_tpu_torch.clients.fedrep import FedBnClientLogic
    from fl4health_tpu_torch.exchange.exchanger import norm_exclusion_exchanger
    from fl4health_tpu_torch.metrics import efficient
    from fl4health_tpu_torch.metrics.base import MetricManager
    from fl4health_tpu_torch.server.simulation import FederatedSimulation
    from fl4health_tpu_torch.strategies.fedavg import FedAvg

    return FederatedSimulation(
        logic=FedBnClientLogic(engine.from_module(BnMlp(8, 3)), engine.masked_cross_entropy),
        tx=optim.sgd(0.05), strategy=FedAvg(), datasets=data, batch_size=8,
        metrics=MetricManager((efficient.accuracy(),)), local_epochs=1,
        exchanger=norm_exclusion_exchanger(), seed=3, device=device,
        **{"execution_mode": "pipelined", **sim_kw})


def fedbn_bn_mlp(fa, dp) -> dict:
    """``fedbn_bn_mlp``: FedBN (``norm_exclusion_exchanger``) on the
    ``BnMlp`` over 64 clients, 2 rounds: the batch statistics and the BN
    scale and bias differ across clients, the Dense layers are equal after
    the pull, no kernel launched; a run saved after round 1 and resumed
    equals the straight run bit for bit; the CPU tests' 3-client fixture
    card against CPU within 5e-4 (losses, params and statistics)."""
    from fl4health_tpu_torch.checkpointing.state import SimulationStateCheckpointer

    data = fedbn_datasets(DP_CLIENTS)
    out = {"phase": "fedbn_bn_mlp", "clients": DP_CLIENTS, "rounds": FEDBN_ROUNDS}
    sim = fedbn_sim(data, "cuda")
    out["run"] = timed_fit(sim, FEDBN_ROUNDS, [fa, dp])
    if any(out["run"]["launches"].values()):
        fail(f"fedbn_bn_mlp: kernels launched {out['run']['launches']}")
    cs = sim.client_states
    stats = {"batch_stats/BatchNorm_0/" + k: v
             for k, v in cs.model_state["batch_stats"]["BatchNorm_0"].items()}
    spread = {"batch_stats": client_spread(stats, "batch_stats"),
              "bn_affine": client_spread(cs.params, "BatchNorm_0"),
              "dense": max(client_spread(cs.params, p) for p in ("Dense_0", "Dense_1"))}
    if spread["batch_stats"] <= 1e-7 or spread["bn_affine"] <= 1e-7 or spread["dense"] > 0:
        fail(f"fedbn_bn_mlp: client spreads {spread}")
    root = ckpt_dir("fedbn")
    try:
        first = fedbn_sim(data, "cuda", state_checkpointer=SimulationStateCheckpointer(root))
        first.fit(1)
        again = fedbn_sim(data, "cuda", state_checkpointer=SimulationStateCheckpointer(root))
        again.fit(FEDBN_ROUNDS)
        if not (again._resume_info["next_round"] == 2 and history_equal(again, sim)
                and states_equal(again, sim)):
            fail("fedbn_bn_mlp: the resumed run differs from the straight run")
    finally:
        drop_dirs(root)
    tiny = fedbn_datasets(3)
    runs = {d: fedbn_sim(tiny, d) for d in ("cpu", "cuda")}
    runs["cuda"].set_global_params(runs["cpu"].global_params)
    for r in runs.values():
        r.fit(3)
    for gr, cr in zip(runs["cuda"].history, runs["cpu"].history, strict=True):
        check(f"tiny fedbn eval loss r{gr.round}", torch.tensor(gr.eval_losses["checkpoint"]),
              torch.tensor(cr.eval_losses["checkpoint"]), 5e-4, 0)
    from fl4health_tpu_torch.core.pytree import tree_leaves

    err = max(check("tiny fedbn client state", g.cpu(), c, 5e-4, 0)
              for g, c in zip(tree_leaves((runs["cuda"].client_states.params,
                                           runs["cuda"].client_states.model_state)),
                              tree_leaves((runs["cpu"].client_states.params,
                                           runs["cpu"].client_states.model_state))))
    out.update({"spread": spread, "resume_bit_equal": True, "tiny_max_abs_err": err,
                "fit_losses": [r.fit_losses["backward"] for r in sim.history]})
    print(json.dumps(out))
    del sim, first, again, runs
    torch.cuda.empty_cache()
    return out


def model_state_slice(fa, dp) -> dict:
    """Phase 39: buffered async and the armed admin plane under a one-rank
    NCCL mesh against their unsharded runs, then FedPM over masked models
    and FedBN's local batch statistics."""
    import torch.distributed as dist

    root = nccl_world()
    try:
        mesh_async = mesh_async_dp_cifar_cnn(dp)
        mesh_ops = mesh_ops_dp_cifar_cnn(dp)
    finally:
        dist.destroy_process_group()
        drop_dirs(root)
    return {"mesh_async": mesh_async, "mesh_ops": mesh_ops, "fedpm": fedpm_mnist(fa, dp),
            "fedbn": fedbn_bn_mlp(fa, dp)}


# -- the algorithm-breadth slice ------------------------------------------------
BREADTH_KINDS = ("ditto_mkmmd", "mrmtl_mkmmd", "ditto_deep_mmd", "mrmtl_deep_mmd", "flash",
                 "feddg_ga", "dynamic_layer", "sparse", "model_merge")
BREADTH_ROUNDS = 2
BREADTH_TINY_ROUNDS = 2
BREADTH_TINY_TOL = 1e-5
FLASH_GAMMA, FLASH_EPOCHS = 0.01, 2  # 2 epochs of 160 rows at batch 32: 10 steps
PCA_COMPONENTS = 8
PCA_TOL = 5e-4


def breadth_arm(kind: str, tiny: bool, train_kernel: bool = True) -> dict:
    """An arm's simulation pieces: ``logic``, ``strategy`` (a factory),
    ``exchanger``, extra simulation arguments. At full width the DP path's
    model, ``CifarNet`` in f32, whose 128-wide Dense is the MMD feature
    ``features``; tiny, the CPU tests' ``Mlp(8 -> 12 -> 3)``. MK-MMD and
    deep MMD at JAX's defaults (interval 20, normalised features, weight
    10); the tiny Ditto MK-MMD at interval 0 with the feature-l2 term, the
    tiny MR-MTL MK-MMD at interval -1 (the QP before every step), the tiny
    deep kernels trained at -1 and 2, or fixed (interval 0) without
    ``train_kernel``."""
    from fl4health_tpu_torch.clients import engine
    from fl4health_tpu_torch.clients import mmd
    from fl4health_tpu_torch.clients.ditto import KeepLocalExchanger
    from fl4health_tpu_torch.exchange import exchanger as ex
    from fl4health_tpu_torch.models.bases import TwinModel
    from fl4health_tpu_torch.models.cnn import CifarNet, Mlp
    from fl4health_tpu_torch.strategies.dynamic_layer import FedAvgDynamicLayer, FedAvgSparse
    from fl4health_tpu_torch.strategies.fedavg import FedAvg
    from fl4health_tpu_torch.strategies.feddg_ga import FedDgGa
    from fl4health_tpu_torch.strategies.flash import Flash
    from fl4health_tpu_torch.strategies.model_merge import ModelMergeStrategy

    net = (lambda: Mlp(8, (12,), 3)) if tiny else (lambda: CifarNet(dtype=torch.float32))
    width = 12 if tiny else 128
    ce, wired = engine.masked_cross_entropy, engine.from_module
    twin_wire = ex.FixedLayerExchanger(TwinModel.exchange_global_model)
    plain = engine.ClientLogic(wired(net()), ce)
    if kind == "ditto_mkmmd":
        kw = dict(beta_global_update_interval=0, feature_l2_norm_weight=0.1) if tiny else {}
        return dict(logic=mmd.DittoMkMmdClientLogic(wired(TwinModel(net(), net())), ce,
                                                    feature_model=wired(net()), **kw),
                    strategy=FedAvg, exchanger=twin_wire)
    if kind == "mrmtl_mkmmd":
        kw = dict(beta_global_update_interval=-1) if tiny else {}
        return dict(logic=mmd.MrMtlMkMmdClientLogic(wired(net()), ce, **kw),
                    strategy=FedAvg, exchanger=KeepLocalExchanger())
    # the tiny deep arms at JAX's tests' weight 1 (their default 10 makes a
    # one-ulp input change move the tiny run by 7.5e-4)
    tiny_deep = dict(optimization_steps=1, deep_mmd_loss_weight=1.0)
    if kind == "ditto_deep_mmd":
        kw = dict(mmd_kernel_train_interval=-1 if train_kernel else 0,
                  **tiny_deep) if tiny else {}
        return dict(logic=mmd.DittoDeepMmdClientLogic(
                        wired(TwinModel(net(), net())), ce, feature_model=wired(net()),
                        feature_sizes={"features": width}, **kw),
                    strategy=FedAvg, exchanger=twin_wire)
    if kind == "mrmtl_deep_mmd":
        kw = dict(mmd_kernel_train_interval=2 if train_kernel else 0,
                  **tiny_deep) if tiny else {}
        return dict(logic=mmd.MrMtlDeepMmdClientLogic(wired(net()), ce,
                                                      feature_sizes={"features": width}, **kw),
                    strategy=FedAvg, exchanger=KeepLocalExchanger())
    if kind == "flash":
        from fl4health_tpu_torch.clients.flash import FlashEarlyStopConfig

        return dict(logic=plain, strategy=Flash, sim=dict(
            local_epochs=FLASH_EPOCHS,
            flash_early_stopping=FlashEarlyStopConfig(FLASH_GAMMA, FLASH_EPOCHS)))
    if kind == "feddg_ga":
        n = 3 if tiny else DP_CLIENTS
        return dict(logic=plain, strategy=lambda: FedDgGa(n_clients=n, num_rounds=4))
    if kind == "dynamic_layer":
        return dict(logic=plain, strategy=FedAvgDynamicLayer,
                    exchanger=ex.DynamicLayerExchanger(mode="topk", exchange_fraction=0.5))
    if kind == "sparse":
        return dict(logic=plain, strategy=FedAvgSparse,
                    exchanger=ex.SparseExchanger(sparsity_level=0.3))
    if kind == "model_merge":
        return dict(logic=plain, strategy=ModelMergeStrategy)
    raise ValueError(kind)


def breadth_sim(kind: str, tiny: bool, device: str, mode: str = "pipelined",
                nudge: float = 0.0, train_kernel: bool = True):
    """An arm's simulation: SGD(0.05), f32; tiny: the split-model fixture's
    3 clients, batch 8, one local epoch, seed 3; else the 64
    ``dp_cifar_cnn`` clients, batch 32, 5 local steps (Flash: 2 epochs),
    seed 0. ``nudge`` (+inf or -inf): every training input one ulp that
    way (the run's own sensitivity). ``train_kernel``: see
    :func:`breadth_arm`."""
    from fl4health_tpu_torch import optim
    from fl4health_tpu_torch.metrics import efficient
    from fl4health_tpu_torch.metrics.base import MetricManager
    from fl4health_tpu_torch.server.simulation import ClientDataset, FederatedSimulation

    arm = breadth_arm(kind, tiny, train_kernel)
    data = pfl_datasets(tiny, False, device)
    if nudge:
        step = lambda x: torch.nextafter(x, torch.full_like(x, nudge))  # noqa: E731
        data = [ClientDataset(step(torch.as_tensor(d.x_train)), d.y_train, d.x_val, d.y_val)
                for d in data]
    kw = arm.get("sim") or (dict(local_epochs=1) if tiny else dict(local_steps=LOCAL_STEPS))
    if tiny and "flash_early_stopping" in kw:
        from fl4health_tpu_torch.clients.flash import FlashEarlyStopConfig

        kw = dict(local_epochs=3, flash_early_stopping=FlashEarlyStopConfig(1e-3, 3))
    return FederatedSimulation(
        logic=arm["logic"], tx=optim.sgd(0.05), strategy=arm["strategy"](),
        datasets=data, batch_size=8 if tiny else BATCH,
        metrics=MetricManager((efficient.accuracy(),)), exchanger=arm.get("exchanger"),
        seed=3 if tiny else 0, execution_mode=mode, device=device, **kw)


def local_models(sim) -> None:
    """The clients' locally trained models, as the model-merge clients bring
    them: one round of local training on the next round's plan (its
    ``_fit_round``), the trained client states kept, the server's left."""
    mask = torch.ones((sim.n_clients,), dtype=torch.float32, device=sim.device)
    _, sim.client_states, _, _, _ = sim._fit_round(
        sim.server_state, sim.client_states, sim._round_batches(len(sim.history) + 1), mask,
        len(sim.history) + 1, sim._val_batches()[0])


def merge_and_evaluate(sim) -> dict:
    """``ModelMergeServer``'s merge of the local models and its evaluation,
    then ``EvaluateServer`` on the merged model again (same numbers)."""
    from fl4health_tpu_torch.server.servers import EvaluateServer, ModelMergeServer

    local_models(sim)
    merged, losses, metrics = ModelMergeServer(sim).fit()
    again = EvaluateServer(sim).fit()
    if again != (losses, metrics):
        fail(f"model_merge: EvaluateServer {again} differs from the merge's {losses, metrics}")
    return {"merged": merged, "eval_losses": losses, "eval_metrics": metrics}


def _history_gap(a, b) -> float:
    """The largest difference of two runs' fit and eval losses (every key);
    fails on differing keys or non-finite values."""
    worst = 0.0
    for x, y in zip(a.history, b.history, strict=True):
        for field in ("fit_losses", "eval_losses"):
            u, v = getattr(x, field), getattr(y, field)
            if set(u) != set(v) or not all(np.isfinite(w) for w in u.values()):
                fail(f"round {x.round}: {field} {u} against {v}")
            worst = max(worst, *(abs(u[k] - v[k]) for k in u))
    return worst


def _kernel_gaps(a: dict, b: dict) -> tuple[float, float]:
    """Two deep kernels' largest and mean entry gaps, the mean without the
    last layer's bias: it cancels in every feature distance, so its
    gradient is 0 in real arithmetic and adamw moves it by rounding alone."""
    last = max(k for k in b if k.startswith("featurizer/")).rsplit("/", 1)[0] + "/bias"
    gaps = {k: (a[k].cpu().double() - b[k].double()).abs().flatten() for k in b}
    return (max(float(g.max()) for g in gaps.values()),
            float(torch.cat([g for k, g in gaps.items() if k != last]).mean()))


def _deep_kernel(sim) -> dict:
    return sim.client_states.extra["deep_mmd"]["features"]


def tiny_breadth_parity() -> dict:
    """Every arm's tiny fixture on the card and on the CPU, 2 rounds from the
    same init: each round's fit and eval losses (every key) within 1e-5;
    the model-merge arm also its merged model's evaluation. Each deep arm
    runs with its kernel fixed and trained. The kernel is sharp
    (``sigma_phi`` 0.005): even a fixed kernel's tiny run moves by more
    than 1e-5 on a one-ulp input change; and its training ascends a
    t-statistic whose variance is a difference of two nearly equal f32
    sums, Adam turning its rounding into lr-sized moves. So the deep arms'
    losses are held to the larger of 1e-5 and twice the CPU run's own move
    when its inputs move by one ulp (up or down), and a trained kernel's
    params to the CPU's own spread: the largest entry gap within twice,
    the mean entry gap within 4 times the nudged runs' largest."""
    err, deep_arms = {}, {}
    for kind in BREADTH_KINDS:
        deep = "deep_mmd" in kind
        for trained in (False, True) if deep else (True,):
            name = f"{kind}_{'trained' if trained else 'fixed'}" if deep else kind
            make = functools.partial(breadth_sim, kind, True, train_kernel=trained)
            runs = {"card": make("cuda"), "cpu": make("cpu")}
            ways = (float("inf"), float("-inf")) if deep else ()
            for way in ways:
                runs[f"cpu_nudged{way}"] = make("cpu", nudge=way)
            for sim in runs.values():
                sim.fit(BREADTH_TINY_ROUNDS)
            worst = _history_gap(runs["card"], runs["cpu"])
            if kind == "model_merge":
                m_card, m_cpu = (merge_and_evaluate(runs[d]) for d in ("card", "cpu"))
                worst = max(worst, *(abs(m_card["eval_losses"][k] - m_cpu["eval_losses"][k])
                                     for k in m_cpu["eval_losses"]))
            bound = BREADTH_TINY_TOL
            if not deep:
                err[name] = worst
            else:
                own = max(_history_gap(runs[f"cpu_nudged{way}"], runs["cpu"]) for way in ways)
                bound = max(BREADTH_TINY_TOL, 2 * own)
                arm = deep_arms[name] = {"card_vs_cpu": worst, "cpu_one_ulp": own,
                                         "bound": bound}
            if not worst <= bound:
                fail(f"tiny {name}: card-vs-CPU max abs err {worst} > {bound}")
            if deep and trained:
                kc, kp = _deep_kernel(runs["card"]), _deep_kernel(runs["cpu"])
                steps = int(kp.opt_state[0].count.max())
                spread = [_kernel_gaps(_deep_kernel(runs[f"cpu_nudged{way}"]).params, kp.params)
                          for way in ways]
                gap_max, gap_mean = _kernel_gaps(kc.params, kp.params)
                own_max, own_mean = (max(g[i] for g in spread) for i in (0, 1))
                arm.update({"adam_steps": steps, "kernel_gap_max": gap_max,
                            "kernel_gap_mean": gap_mean, "cpu_one_ulp_kernel_max": own_max,
                            "cpu_one_ulp_kernel_mean": own_mean})
                if not (steps > 0 and gap_max <= 2 * own_max and gap_mean <= 4 * own_mean):
                    fail(f"tiny {name}: kernel params part by {gap_max} (mean {gap_mean}) "
                         f"after {steps} adamw steps; the CPU's one-ulp spread {own_max} "
                         f"(mean {own_mean})")
    out = {"phase": "tiny_breadth_parity", "rounds": BREADTH_TINY_ROUNDS,
           "max_abs_err": err, "deep_mmd": deep_arms}
    print(json.dumps(out))
    return out


class HostTimer:
    """Wraps a module function: the host seconds and calls spent in it (its
    ops' dispatch; the device runs them behind)."""

    def __init__(self, module, name: str):
        self.module, self.name, self.inner = module, name, getattr(module, name)
        self.seconds, self.calls = 0.0, 0

    def __enter__(self):
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return self.inner(*args, **kwargs)
            finally:
                self.seconds += time.perf_counter() - t0
                self.calls += 1

        setattr(self.module, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.inner)


def all_launches(fa, dp) -> dict:
    """K1-K5's launch counts (the tensor-core ones are among K3-K5's)."""
    return {k: v for c in (fa.LAUNCHES, dp.LAUNCHES) for k, v in c.items()}


def breadth_arm_run(kind: str, fa, dp) -> dict:
    """One arm at full width: the pipelined route (a cold round, then a warm
    round timed, the peak above the arm's start), the chunked route's 2
    rounds bit for bit the pipelined ones (FedDG-GA, whose eval update
    keeps it pipelined as in JAX: the chunked route refused, the inline
    rounds bit for bit instead); MK-MMD's warm round also the QP's host
    time; model merge also the merge and evaluation of local models."""
    from fl4health_tpu_torch.clients import mmd

    sims = {}
    t_arm = time.time()
    sim = breadth_sim(kind, False, "cuda")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    sim.fit(1)
    torch.cuda.synchronize()
    cold = time.time() - t0
    with HostTimer(mmd, "optimize_betas") as qp:
        t0 = time.time()
        sim.fit(1)
        torch.cuda.synchronize()
        warm = time.time() - t0
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    sims["pipelined"] = sim
    for r in sim.history:
        values = [*r.fit_losses.values(), *r.eval_losses.values()]
        if not all(np.isfinite(v) for v in values):
            fail(f"{kind}_cifar_cnn round {r.round}: non-finite losses {r.fit_losses} "
                 f"{r.eval_losses}")
    other = "inline" if kind == "feddg_ga" else "chunked"
    if kind == "feddg_ga":
        try:
            breadth_sim(kind, False, "cuda", mode="chunked").fit(1)
            fail("feddg_ga_cifar_cnn: the chunked route was not refused")
        except ValueError as e:
            if "update_after_eval" not in str(e):
                raise
        twin = breadth_sim(kind, False, "cuda")
        inline_rounds(twin, BREADTH_ROUNDS)
    else:
        twin = breadth_sim(kind, False, "cuda", mode="chunked")
        twin.fit(BREADTH_ROUNDS)
    equal = history_equal(sim, twin) and states_equal(sim, twin)
    if not equal:
        fail(f"{kind}_cifar_cnn: the {other} route parts from the pipelined route")
    arm = {"phase": f"{kind}_cifar_cnn", "clients": DP_CLIENTS, "cold_round_s": cold,
           "warm_round_s": warm, "peak_gib_above_start": peak,
           f"{other}_bit_equal": equal,
           "fit_losses": [r.fit_losses for r in sim.history],
           "eval_losses": [r.eval_losses["checkpoint"] for r in sim.history]}
    if qp.calls:
        arm.update(qp_host_s_warm_round=qp.seconds, qp_calls_warm_round=qp.calls)
    st = sim.server_state
    if kind in ("ditto_mkmmd", "mrmtl_mkmmd"):
        betas = sim.client_states.extra["mkmmd_betas"]["features"]
        moved = float((betas - 1.0 / 19).abs().max())
        sums = betas.sum(-1)
        if not (moved > 1e-4 and float((sums - 1).abs().max()) < 1e-4):
            fail(f"{kind}_cifar_cnn: betas moved {moved}, sums {sums.min()}..{sums.max()}")
        arm["betas_moved"] = moved
    if kind in ("ditto_deep_mmd", "mrmtl_deep_mmd"):
        k = sim.client_states.extra["deep_mmd"]["features"]
        steps = int(k.opt_state[0].count.min())
        if steps < 5:  # one kernel training a round, 5 steps each
            fail(f"{kind}_cifar_cnn: the kernels trained {steps} steps")
        arm["kernel_adam_steps"] = steps
    if kind == "feddg_ga":
        w = st.adjustment_weights
        arm["adjustment_weights"] = [float(w.min()), float(w.max())]
        if not (abs(float(w.sum()) - 1.0) < 1e-5 and float(w.max() - w.min()) > 0.0):
            fail(f"feddg_ga_cifar_cnn: weights {arm['adjustment_weights']}, sum {w.sum()}")
    if kind in ("dynamic_layer", "sparse"):
        sent = torch.cat([v.reshape(-1) for v in st.updated.values()])
        arm["updated_share"] = float(sent.mean())
        if not 0.0 < arm["updated_share"] <= 1.0:
            fail(f"{kind}_cifar_cnn: aggregation refreshed {arm['updated_share']}")
    if kind == "model_merge":
        merged = {}
        for name, s in (("pipelined", sim), (other, twin)):
            torch.cuda.synchronize()
            t0 = time.time()
            merged[name] = merge_and_evaluate(s)
            torch.cuda.synchronize()
            arm[f"merge_eval_s_{name}"] = time.time() - t0
        a, b = merged["pipelined"], merged[other]
        if not (a["eval_losses"] == b["eval_losses"] and all(
                torch.equal(a["merged"][k], b["merged"][k]) for k in a["merged"])):
            fail("model_merge_cifar_cnn: the routes' merges differ")
        arm["merged_eval_losses"] = a["eval_losses"]
    arm["arm_wall_s"] = time.time() - t_arm
    print(json.dumps(arm))
    return arm


def fedpca_mnist() -> dict:
    """``fedpca_example``'s flow at the DP path's count: 64 clients' 160 rows
    of 28x28x1 synthetic data flattened to 784, each client's top 8 axes by
    ``PcaModule(low_rank=True)``, ``FedPCA(8)``'s merge, on the card (timed,
    warm) and on the CPU: the singular values within 5e-4 of their size,
    each component after aligning its column's sign and the pooled
    validation rows' explained variance within 5e-4."""
    from fl4health_tpu_torch.models.autoencoders import PcaModule
    from fl4health_tpu_torch.strategies.base import FitResults
    from fl4health_tpu_torch.strategies.fedpca import FedPCA, PcaPacket

    data = image_datasets(DP_CLIENTS, DP_TRAIN, DP_VAL, (28, 28, 1))

    def merge(device):
        pca, strategy = PcaModule(low_rank=True, rank_estimation=PCA_COMPONENTS), FedPCA(
            PCA_COMPONENTS)
        states = [pca.fit(torch.as_tensor(d.x_train).to(device).reshape(len(d.x_train), -1))
                  for d in data]
        server = strategy.init({"components": states[0].components,
                                "singular_values": states[0].singular_values})
        results = FitResults(
            packets=PcaPacket(torch.stack([s.components for s in states]),
                              torch.stack([s.singular_values for s in states])),
            sample_counts=torch.full((DP_CLIENTS,), float(DP_TRAIN), device=device),
            train_losses={}, train_metrics={},
            mask=torch.ones((DP_CLIENTS,), device=device))
        return strategy.aggregate(server, results, 1)

    walls = []
    for _ in range(2):  # cold, then warm
        torch.cuda.synchronize()
        t0 = time.time()
        card = merge("cuda")
        torch.cuda.synchronize()
        walls.append(time.time() - t0)
    cpu = merge("cpu")
    # the singular values are a few hundred: held relative to their size
    # (5e-4 absolute is below f32's resolution there)
    sv = check("fedpca singular values", card.singular_values.cpu(), cpu.singular_values,
               0, PCA_TOL)
    got, want = card.components.cpu(), cpu.components
    signs = torch.sign((got * want).sum(0))
    comp = check("fedpca components (signs aligned)", got * signs, want, PCA_TOL, 0)
    pooled = torch.cat([torch.as_tensor(d.x_val).reshape(len(d.x_val), -1) for d in data])
    pooled = pooled - pooled.mean(0)
    ratio = {name: float(((pooled @ u) ** 2).sum() / (pooled ** 2).sum())
             for name, u in (("card", got), ("cpu", want))}
    if not abs(ratio["card"] - ratio["cpu"]) <= PCA_TOL:
        fail(f"fedpca_mnist: explained variance card {ratio['card']} CPU {ratio['cpu']}")
    out = {"phase": "fedpca_mnist", "clients": DP_CLIENTS, "rows": DP_TRAIN, "width": 784,
           "components": PCA_COMPONENTS, "cold_s": walls[0], "warm_s": walls[1],
           "singular_values": [float(v) for v in cpu.singular_values],
           "singular_values_max_abs_err": sv, "components_max_abs_err": comp,
           "signs_flipped": int((signs < 0).sum()), "explained_variance": ratio}
    print(json.dumps(out))
    return out


def breadth_slice(fa, dp) -> dict:
    """Phase 40: the tiny fixtures card against CPU, the nine arms at the DP
    path's width and traffic (64 clients, batch 32, 5 SGD(0.05) steps, f32,
    2 rounds), FedPCA's merge card against CPU; K1-K5 launch 0 times over
    the phase, as in JAX."""
    fa.reset_launch_counts()
    dp.reset_launch_counts()
    t_phase = time.time()
    tiny = tiny_breadth_parity()
    tiny_wall = time.time() - t_phase
    arms = {}
    for kind in BREADTH_KINDS:
        arms[kind] = breadth_arm_run(kind, fa, dp)
        torch.cuda.empty_cache()
    pca = fedpca_mnist()
    launches = all_launches(fa, dp)
    if any(launches.values()):
        fail(f"phase 40 launched K1-K5: {launches}")
    out = {"phase": "algorithm_breadth", "arms": len(arms) + 1,
           "wall_s": time.time() - t_phase,
           "tiny_max_abs_err": max(tiny["max_abs_err"].values()),
           "tiny_deep_mmd": tiny["deep_mmd"], "tiny_wall_s": tiny_wall,
           "arm_wall_s": {k: a["arm_wall_s"] for k, a in arms.items()},
           "warm_round_s": {k: a["warm_round_s"] for k, a in arms.items()},
           "peak_gib_above_start": {k: a["peak_gib_above_start"] for k, a in arms.items()},
           "qp_host_s_warm_round": {k: arms[k]["qp_host_s_warm_round"]
                                    for k in ("ditto_mkmmd", "mrmtl_mkmmd")},
           "fedpca_warm_s": pca["warm_s"], "launches": launches}
    print(card_line())
    print(json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# Phase 41: the cross-silo slice
# ---------------------------------------------------------------------------

# research/fedprox_cluster/run_local_cluster.py at its published sizes, and
# at its FL4HEALTH_SWEEP_TINY sizes for the card-against-CPU run
XS_FEDPROX = dict(silos=5, rounds=8, runs=3, rows=120, dim=30, classes=6, steps=4, batch=8,
                  mus=(0.01, 0.1, 1.0))
XS_FEDPROX_TINY = dict(silos=2, rounds=2, runs=1, rows=24, dim=8, classes=3, steps=2, batch=8,
                       mus=(0.1,))
# the DP path's client as a silo: CifarNet (bf16 compute), 160 rows, batch
# 32, 5 DP-SGD steps (C 1, sigma 1), SGD(0.05); 4 silos, 2 rounds. Tiny: the
# CPU test's DP composition (an Mlp(8, (16,), 3) of 24 rows, f32)
XS_DP = dict(silos=4, rounds=2, rows=160, batch=32, steps=5)
XS_DP_TINY = dict(silos=2, rounds=2, rows=24, batch=8, steps=2)
# examples/cross_silo_buffered_async_example/run.py and its config.yaml:
# 4 silos of 40 rows of synthetic_classification((6,), 3 classes), Mlp
# (16,), SGD(0.05), batch 8, 5 local steps, buffer 2, 4 events, top-k 0.25
# + int8 frames, silo 3 a 0.2 s chaos straggler
XS_ASYNC = dict(silos=4, events=4, k=2, rows=48, n=40, batch=8, steps=5, delay_s=0.2)
XS_ASYNC_TINY = dict(silos=2, events=2, k=2, rows=24, n=16, batch=8, steps=2, delay_s=0.05)
# examples/feature_alignment_example: 3 clients of 60 rows (48 train),
# Adam(5e-3), FedAvg, batch 8, 5 local steps, 3 rounds
XS_TABULAR = dict(rows=60, train=48, rounds=3, batch=8, steps=5)


class XsSilo:
    """One silo: private rows and local training on ``device`` behind a
    ``LoopbackServer`` handler speaking wire frames (the research script's
    ``make_silo``). The received params are cast to the state's dtype and
    device (after round 1 ``weighted_merge`` broadcasts f64, ROADMAP.md
    R13, which JAX's jit casts the same way). The silos of a job are
    threads of one process sharing the card, so they handle requests in
    turns (``lock``): a silo's own work is then timed without the others'
    GIL handoffs, and the kernels' launch counters (plain Python counters)
    count every launch. A round's wall is the sum of its silos', where
    separate machines would give their maximum."""

    def __init__(self, logic, tx, seed: int, x, y, batch: int, steps: int, device: str,
                 lock, ctx_fn=None, reply_fn=None, wrap=None):
        from fl4health_tpu_torch import rng
        from fl4health_tpu_torch.clients import engine
        from fl4health_tpu_torch.metrics import efficient
        from fl4health_tpu_torch.metrics.base import MetricManager
        from fl4health_tpu_torch.transport import LoopbackServer

        self.device = torch.device(device)
        self.x, self.y = x.to(self.device), y.to(self.device)
        self.logic, self.batch, self.steps = logic, batch, steps
        self.ctx_fn, self.reply_fn, self.lock = ctx_fn, reply_fn, lock
        self.state = engine.create_train_state(logic, tx, rng.PRNGKey(seed),
                                               torch.Generator().manual_seed(seed), self.device)
        self.train = engine.make_local_train(
            logic, tx, MetricManager((efficient.accuracy(),)),
            loss_keys=("backward", *getattr(logic, "extra_loss_keys", ())))
        self.handle_s: list[float] = []
        self.server = LoopbackServer(self.handle if wrap is None else wrap(self.handle))
        self.addr = (self.server.host, self.server.port)

    def handle(self, frame: bytes) -> bytes:
        import dataclasses

        from fl4health_tpu_torch.clients import engine
        from fl4health_tpu_torch.transport import decode, encode

        with self.lock:
            t0 = time.perf_counter()
            received = decode(frame, like=self.state.params)
            pulled = {k: v.to(self.device, self.state.params[k].dtype)
                      for k, v in received.items()}
            self.state = dataclasses.replace(self.state, params=pulled)
            ctx = self.ctx_fn(self) if self.ctx_fn else None
            batches = engine.epoch_batches(self.state.rng, self.x, self.y, self.batch,
                                           n_steps=self.steps)
            self.state, losses, metrics, _ = self.train(self.state, ctx, batches)
            if self.reply_fn is not None:
                reply = self.reply_fn(self, pulled)
            else:
                reply = encode({"params": self.state.params,
                                "n": torch.tensor(float(self.x.shape[0])),
                                "loss": losses["backward"], "accuracy": metrics["accuracy"]})
            self.handle_s.append(time.perf_counter() - t0)
        return reply

    def close(self) -> None:
        self.server.close()


def xs_fedprox_job(cfg: dict, mu: float, run_idx: int, device: str, out_dir: str | None):
    """One (mu, run) job of the research script: silos up, FedProx rounds
    over TCP, its JsonReporter-style dump down. Returns the final global
    params, the dump and the rounds' walls and frame bytes."""
    import types

    from fl4health_tpu_torch import optim, rng
    from fl4health_tpu_torch.clients import engine
    from fl4health_tpu_torch.clients.fedprox import FedProxClientLogic
    from fl4health_tpu_torch.datasets.synthetic import fedprox_synthetic
    from fl4health_tpu_torch.models.cnn import Mlp
    from fl4health_tpu_torch.transport import broadcast_round, encode, weighted_merge

    # drawn on the host, so the card and the CPU runs train on the same rows
    shards = fedprox_synthetic(rng.PRNGKey(run_idx), cfg["silos"], cfg["rows"], alpha=0.5,
                               beta=0.5, dim=cfg["dim"], n_classes=cfg["classes"])

    def ctx_fn(silo):  # mu rides the payload in the reference; the job pins it
        return silo.logic.init_round_context(silo.state, types.SimpleNamespace(
            drift_penalty_weight=torch.tensor(mu, device=silo.device)))

    silos, lock = [], threading.Lock()
    for i, (x, y) in enumerate(shards):
        logic = FedProxClientLogic(engine.from_module(Mlp(cfg["dim"], (16,), cfg["classes"])),
                                   engine.masked_cross_entropy)
        silos.append(XsSilo(logic, optim.sgd(0.05), 100 * run_idx + i, x, y, cfg["batch"],
                            cfg["steps"], device, lock, ctx_fn=ctx_fn))
    init = {k: v.cpu() for k, v in silos[0].state.params.items()}
    template = {"params": init, "n": torch.zeros(()), "loss": torch.zeros(()),
                "accuracy": torch.zeros(())}
    params, dump = init, {"host_type": "server", "mu": mu, "rounds": {}}
    walls, frame_bytes = [], []
    try:
        for rnd in range(1, cfg["rounds"] + 1):
            t0 = time.perf_counter()
            replies = broadcast_round([s.addr for s in silos], params, template)
            params, _ = weighted_merge(replies)
            walls.append(time.perf_counter() - t0)
            frame_bytes.append(len(encode(params)))
            dump["rounds"][str(rnd)] = {
                "fit_loss": float(np.mean([float(r["loss"]) for r in replies])),
                "accuracy": float(np.mean([float(r["accuracy"]) for r in replies]))}
    finally:
        for s in silos:
            s.close()
    dump["silo_handle_s"] = [t for s in silos for t in s.handle_s]
    if out_dir is not None:
        run_dir = Path(out_dir) / f"mu_{mu}" / f"Run{run_idx + 1}"
        run_dir.mkdir(parents=True, exist_ok=True)
        (run_dir / "server_metrics.json").write_text(json.dumps(dump, indent=2))
    return params, dump, walls, frame_bytes


def xs_dp_silos(cfg: dict, device: str, tiny: bool, lock) -> list:
    """The DP silos: ``InstanceLevelDpClientLogic`` under ``make_local_train``
    alone (the round context None), as the DP path's client trains."""
    from fl4health_tpu_torch import optim, rng
    from fl4health_tpu_torch.clients import engine
    from fl4health_tpu_torch.clients.instance_level_dp import InstanceLevelDpClientLogic
    from fl4health_tpu_torch.datasets.synthetic import fedprox_synthetic, synthetic_classification
    from fl4health_tpu_torch.models.cnn import CifarNet, Mlp

    silos = []
    for i in range(cfg["silos"]):
        if tiny:
            x, y = fedprox_synthetic(rng.PRNGKey(0), cfg["silos"], cfg["rows"], dim=8,
                                     n_classes=3)[i]
            module = Mlp(8, (16,), 3)
        else:
            x, y = synthetic_classification(rng.PRNGKey(i, device), cfg["rows"], (32, 32, 3), 10)
            module = CifarNet(dtype=torch.bfloat16, input_shape=(32, 32, 3))
        logic = InstanceLevelDpClientLogic(engine.from_module(module),
                                           engine.masked_cross_entropy, clipping_bound=DP_CLIP,
                                           noise_multiplier=DP_SIGMA)
        silos.append(XsSilo(logic, optim.sgd(0.05), i, x, y, cfg["batch"], cfg["steps"],
                            device, lock))
    return silos


def xs_dp_job(cfg: dict, device: str, tiny: bool, dp=None) -> dict:
    """``cross_silo_dp_cifar_cnn``: ``broadcast_round`` and
    ``weighted_merge`` over the DP silos; each round's frame bytes, the
    encode and decode ms of its frames, its wall, K1/K2 launches."""
    from fl4health_tpu_torch.transport import broadcast_round, decode, encode, weighted_merge

    silos = xs_dp_silos(cfg, device, tiny, threading.Lock())
    # round 1 broadcasts silo 0's init from the card (each leaf pulled by
    # the encode), later rounds the merged f64 params from the host
    params = dict(silos[0].state.params)
    template = {"params": params, "n": torch.zeros(()), "loss": torch.zeros(()),
                "accuracy": torch.zeros(())}
    out = {"rounds": [], "losses": []}
    try:
        if dp is not None:
            dp.reset_launch_counts()
        for _ in range(cfg["rounds"]):
            frame = encode(params)
            encode_ms = 1e3 * min(timed(lambda: encode(params)) for _ in range(3))
            t0 = time.perf_counter()
            replies = broadcast_round([s.addr for s in silos], params, template)
            wall = time.perf_counter() - t0
            reply_frame = encode(replies[0])
            decode_ms = 1e3 * min(timed(lambda: decode(reply_frame, like=template))
                                  for _ in range(3))
            params, _ = weighted_merge(replies)
            out["rounds"].append({"frame_bytes": len(frame), "reply_bytes": len(reply_frame),
                                  "frame_dtype": frame_dtype(frame),
                                  "encode_ms": encode_ms, "decode_ms": decode_ms,
                                  "wall_s": wall,
                                  "silo_handle_s": [s.handle_s[-1] for s in silos]})
            out["losses"].append([float(r["loss"]) for r in replies])
        if dp is not None:
            torch.cuda.synchronize()
            out["launches"] = dict(dp.LAUNCHES)
    finally:
        for s in silos:
            s.close()
    out["params"] = params
    return out


def timed(fn) -> float:
    """The host seconds of one call of ``fn``."""
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def frame_dtype(frame: bytes) -> str:
    """The dtype of a dense frame's first leaf (its header)."""
    from fl4health_tpu_torch.transport.native import get_framing

    return json.loads(get_framing().unframe(frame)[0])["leaves"][0]["dtype"]


def xs_async_job(cfg: dict, device: str) -> dict:
    """``cross_silo_async_compressed``: the buffered-async example's recipe
    with traced frames: every silo replies a COMPRESSED delta (top-k 0.25,
    int8), silo ``silos - 1`` straggles behind ``chaos_handler``'s delay,
    a ``SiloUpdateBuffer`` takes ``k`` updates an event and discounts each
    by its staleness. The tracer is on, so each dispatch carries a trace
    context and each silo runs under ``traced_handler``: the flow ids of
    the coordinator's starts, the silos' steps and the replies' ends."""
    from fl4health_tpu_torch import optim, rng
    from fl4health_tpu_torch.clients import engine
    from fl4health_tpu_torch.compression.config import CompressionConfig
    from fl4health_tpu_torch.datasets.synthetic import synthetic_classification
    from fl4health_tpu_torch.models.cnn import Mlp
    from fl4health_tpu_torch.observability import traced_handler
    from fl4health_tpu_torch.observability.spans import Tracer, set_tracer
    from fl4health_tpu_torch.resilience import TransportFaultPolicy, chaos_handler
    from fl4health_tpu_torch.server.async_schedule import staleness_discount
    from fl4health_tpu_torch.transport import SiloUpdateBuffer, encode
    from fl4health_tpu_torch.transport.codec import decode_compressed, encode_compressed

    comp = CompressionConfig(topk_fraction=0.25, quant_bits=8)

    def delta_reply(silo, pulled):
        return encode_compressed({k: (silo.state.params[k] - pulled[k]).float()
                                  for k in pulled}, comp)

    silos, lock = [], threading.Lock()
    for s in range(cfg["silos"]):
        x, y = synthetic_classification(rng.PRNGKey(s), cfg["rows"], (6,), 3, class_sep=2.0)
        slow = s == cfg["silos"] - 1

        def wrap(handler, slow=slow, s=s):
            handler = traced_handler(handler)
            if slow:
                handler = chaos_handler(handler, TransportFaultPolicy(
                    delay_s=cfg["delay_s"], delay_probability=1.0), seed=0, silo_idx=s)
            return handler

        logic = engine.ClientLogic(engine.from_module(Mlp(6, (16,), 3)),
                                   engine.masked_cross_entropy)
        silos.append(XsSilo(logic, optim.sgd(0.05), s, x[:cfg["n"]], y[:cfg["n"]],
                            cfg["batch"], cfg["steps"], device, lock, reply_fn=delta_reply,
                            wrap=wrap))
    init = {k: v.cpu() for k, v in silos[0].state.params.items()}
    addrs = [s.addr for s in silos]
    counts = {f"{h}:{p}": float(cfg["n"]) for h, p in addrs}
    tracer = Tracer(enabled=True)
    prev = set_tracer(tracer)
    buffer = SiloUpdateBuffer(init, decoder=lambda raw: decode_compressed(raw, like=init))
    params, version, events = init, 0, []
    try:
        buffer.dispatch(addrs, params, version)
        for event in range(1, cfg["events"] + 1):
            t0 = time.perf_counter()
            arrivals = buffer.take(cfg["k"], timeout=120.0)
            stal = [float(version - a.version) for a in arrivals]
            w = np.asarray([counts[a.result.silo] for a in arrivals]) * np.asarray(
                staleness_discount(np.asarray(stal)))
            w = w / w.sum()
            params = {k: params[k] + sum(float(wi) * a.reply[k] for wi, a in zip(w, arrivals))
                      for k in params}
            version += 1
            consumed = [next(a for a in addrs if f"{a[0]}:{a[1]}" == r.result.silo)
                        for r in arrivals]
            buffer.dispatch(consumed, params, version)
            events.append({"event": event, "arrived": [a.result.silo.split(":")[-1]
                                                       for a in arrivals],
                           "staleness": stal, "wall_s": time.perf_counter() - t0})
        leftover = buffer.take(buffer.in_flight() + buffer.pending(), timeout=120.0)
    finally:
        buffer.close()
        for s in silos:
            s.close()
        set_tracer(prev)
    flows = {ph: sorted({e["id"] for e in tracer.events if e.get("ph") == ph})
             for ph in ("s", "t", "f")}
    comp_bytes = len(encode_compressed(init, comp))
    return {"events": events, "params": params, "flows": flows,
            "late_staleness": [float(version - a.version) for a in leftover],
            "wire_bytes_dense": len(encode(init)), "wire_bytes_compressed": comp_bytes}


class ColumnTable:
    """A column table without pandas (the card's machine has none):
    ``.columns``, ``len()`` and ``[name]``, all that feature alignment
    reads."""

    def __init__(self, columns: dict):
        self._cols = dict(columns)

    @property
    def columns(self):
        return list(self._cols)

    def __len__(self):
        return len(next(iter(self._cols.values())))

    def __getitem__(self, name):
        return self._cols[name]


def tabular_frame(n: int, seed: int, drop: bool = False) -> ColumnTable:
    """The example's frame: age, bp (absent where ``drop``), sex, outcome."""
    r = np.random.default_rng(seed)
    age, bp = r.uniform(20, 90, n), r.uniform(90, 180, n)
    sex = r.choice(["F", "M"], n).astype(object)
    score = (age / 90 + (bp - 90) / 90 + (sex == "M") * 0.3) / 2.3
    y = (score + r.normal(0, 0.15, n) > 0.55).astype(int).astype(str).astype(object)
    d = {"pid": np.arange(n), "age": age, "bp": bp, "sex": sex, "outcome": y}
    if drop:
        del d["bp"]
    return ColumnTable(d)


def xs_tabular_job(device: str, init: dict | None = None) -> tuple:
    """``tabular_alignment``: the example's three clients (the second
    without ``bp``), the two polls, then FedAvg on ``device`` with
    ``balanced_accuracy``, ``f1`` and ``binned_auc`` on the eval path. The
    server keeps the simulation's initial params (``initial_params``)."""
    from fl4health_tpu_torch import optim
    from fl4health_tpu_torch.clients import engine
    from fl4health_tpu_torch.feature_alignment.orchestration import (
        TabularDataClient, TabularFeatureAlignmentServer)
    from fl4health_tpu_torch.metrics import efficient
    from fl4health_tpu_torch.metrics.base import MetricManager
    from fl4health_tpu_torch.models.cnn import Mlp
    from fl4health_tpu_torch.server.simulation import ClientDataset, FederatedSimulation
    from fl4health_tpu_torch.strategies.fedavg import FedAvg

    cfg = XS_TABULAR
    clients = [TabularDataClient(tabular_frame(cfg["rows"], s, drop=(s == 2)), "pid",
                                 ["outcome"]) for s in (1, 2, 3)]

    def builder(in_dim, out_dim, aligned):
        data = []
        for c in aligned:
            x, y = c.aligned_arrays()
            y = y.astype(np.int32)
            n = cfg["train"]
            data.append(ClientDataset(x[:n], y[:n], x[n:], y[n:]))
        sim = FederatedSimulation(
            logic=engine.ClientLogic(engine.from_module(Mlp(in_dim, (16,), out_dim)),
                                     engine.masked_cross_entropy),
            tx=optim.adam(5e-3), strategy=FedAvg(), datasets=data, batch_size=cfg["batch"],
            metrics=MetricManager((efficient.accuracy(), efficient.balanced_accuracy(out_dim),
                                   efficient.f1(out_dim), efficient.binned_auc())),
            local_steps=cfg["steps"], seed=0, device=device)
        if init is not None:
            sim.set_global_params(init)
        server.initial_params = {k: v.cpu().clone() for k, v in sim.global_params.items()}
        return sim

    server = TabularFeatureAlignmentServer({}, clients, builder)
    t0 = time.perf_counter()
    hist = server.fit(cfg["rounds"])
    if device == "cuda":
        torch.cuda.synchronize()
    return server, hist, time.perf_counter() - t0


def xs_card_vs_cpu() -> dict:
    """Each arm's tiny run on the card against the CPU, 5e-4: the FedProx
    job, the DP job (K1/K2 on the card, their plain versions on the CPU),
    the async job with every silo consumed each event (an order-free merge)
    and the tabular run."""
    errs = {}
    (gp, gd, _, _), (cp, cd, _, _) = (xs_fedprox_job(XS_FEDPROX_TINY, 0.1, 0, d, None)
                                      for d in ("cuda", "cpu"))
    for r in gd["rounds"]:
        check(f"xs fedprox tiny loss r{r}", torch.tensor(gd["rounds"][r]["fit_loss"]),
              torch.tensor(cd["rounds"][r]["fit_loss"]), 5e-4, 0)
    errs["fedprox"] = max(check(f"xs fedprox tiny {k}", gp[k], cp[k], 5e-4, 0) for k in cp)
    g, c = (xs_dp_job(XS_DP_TINY, d, True) for d in ("cuda", "cpu"))
    check("xs dp tiny losses", torch.tensor(g["losses"]), torch.tensor(c["losses"]), 5e-4, 0)
    errs["dp"] = max(check(f"xs dp tiny {k}", g["params"][k], c["params"][k], 5e-4, 0)
                     for k in c["params"])
    tiny_async = dict(XS_ASYNC_TINY, k=XS_ASYNC_TINY["silos"])
    g, c = (xs_async_job(tiny_async, d) for d in ("cuda", "cpu"))
    errs["async"] = max(check(f"xs async tiny {k}", g["params"][k], c["params"][k], 5e-4, 0)
                        for k in c["params"])
    gs, gh, _ = xs_tabular_job("cuda")
    cs, ch, _ = xs_tabular_job("cpu", init=gs.initial_params)
    errs["tabular"] = xs_tabular_compare(gs, gh, cs, ch)
    return errs


def xs_tabular_compare(gs, gh, cs, ch) -> float:
    """The card's tabular run against the CPU's (started from the card
    run's initial params) over the same aligned arrays."""
    for gc, cc in zip(gs.clients, cs.clients):
        for a, b in zip(gc.aligned_arrays(), cc.aligned_arrays()):
            if not np.array_equal(a, b):
                fail("tabular_alignment: the aligned arrays differ between the runs")
    err = 0.0
    for gr, cr in zip(gh, ch, strict=True):
        for got, want in ((gr.fit_losses, cr.fit_losses), (gr.eval_losses, cr.eval_losses),
                          (gr.eval_metrics, cr.eval_metrics)):
            for k in want:
                err = max(err, check(f"tabular r{gr.round} {k}", torch.tensor(got[k]),
                                     torch.tensor(want[k]), 5e-4, 0))
    return err


def cross_silo_slice(fa, dp) -> dict:
    """Phase 41: the cross-silo transport, the metrics and data tail and
    feature alignment on the card. The native framing must be live; the
    tiny arms run on the card against the CPU (5e-4); then the four arms at
    their published sizes. K1/K2 launch in the DP arm alone (5 and 40 a
    silo-round), K3-K5 not at all."""
    from fl4health_tpu_torch.transport import native
    from fl4health_tpu_torch.utils.hp_search import find_best_hp_dir

    t_phase = time.time()
    t0 = time.perf_counter()
    lib = native.get_native()
    build_s = time.perf_counter() - t0
    if lib is None:
        fail("phase 41: the native framing did not build (the Python twin is live)")
    fa.reset_launch_counts()
    dp.reset_launch_counts()
    tiny = xs_card_vs_cpu()
    tiny_wall = time.time() - t_phase
    fa.reset_launch_counts()
    dp.reset_launch_counts()

    # cross_silo_fedprox: the research script's mu grid, find_best_hp_dir
    root = ckpt_dir("cluster")
    cfg = XS_FEDPROX
    t0 = time.time()
    jobs = {}
    for mu in cfg["mus"]:
        for run_idx in range(cfg["runs"]):
            _, dump, walls, nbytes = xs_fedprox_job(cfg, mu, run_idx, "cuda", root)
            jobs[(mu, run_idx)] = {"final_accuracy": dump["rounds"][str(cfg["rounds"])]
                                   ["accuracy"], "round_walls_s": walls, "frame_bytes": nbytes,
                                   "silo_handle_s": dump.pop("silo_handle_s")}
    best_dir, best_score = find_best_hp_dir(root, metric="accuracy", minimize=False)
    drop_dirs(root)
    fedprox = {"arm": "cross_silo_fedprox", "wall_s": time.time() - t0, "jobs": len(jobs),
               "best": best_dir.name if best_dir else None, "best_mean_accuracy": best_score,
               "round_wall_s": [min(w for j in jobs.values() for w in j["round_walls_s"]),
                                max(w for j in jobs.values() for w in j["round_walls_s"])],
               "frame_bytes": sorted({b for j in jobs.values() for b in j["frame_bytes"]}),
               "silo_handle_ms_median": 1e3 * statistics.median(
                   t for j in jobs.values() for t in j["silo_handle_s"]),
               "final_accuracy": {f"mu_{m}/Run{r + 1}": j["final_accuracy"]
                                  for (m, r), j in jobs.items()}}
    if best_dir is None or not all(np.isfinite(j["final_accuracy"]) for j in jobs.values()):
        fail(f"cross_silo_fedprox: no selection or a non-finite run: {fedprox}")
    print(json.dumps(fedprox))

    # cross_silo_dp_cifar_cnn: K1/K2 in each DP silo
    t0 = time.time()
    dpj = xs_dp_job(XS_DP, "cuda", False, dp)
    silo_rounds = XS_DP["silos"] * XS_DP["rounds"]
    per = {k: v / silo_rounds for k, v in dpj["launches"].items()}
    want = {"dp_sq_norms": XS_DP["steps"], "dp_scaled_sum": XS_DP["steps"] * len(CIFAR_LEAVES)}
    dp_arm = {"arm": "cross_silo_dp_cifar_cnn", "wall_s": time.time() - t0,
              "rounds": dpj["rounds"], "launches": dpj["launches"],
              "launches_per_silo_round": per,
              "losses": dpj["losses"]}
    print(json.dumps(dp_arm))
    if per != want:
        fail(f"cross_silo_dp_cifar_cnn launches {per} a silo-round, expected {want}")
    r1, r2 = dpj["rounds"][0], dpj["rounds"][1]
    if (r1["frame_dtype"], r2["frame_dtype"]) != ("float32", "float64"):
        fail(f"cross_silo_dp_cifar_cnn: frames {r1['frame_dtype']}, {r2['frame_dtype']}; "
             "R13 gives f32 then f64")
    if not all(np.isfinite(v) for row in dpj["losses"] for v in row):
        fail(f"cross_silo_dp_cifar_cnn: non-finite losses {dpj['losses']}")

    # cross_silo_async_compressed
    t0 = time.time()
    aj = xs_async_job(XS_ASYNC, "cuda")
    starts = set(aj["flows"]["s"])
    async_arm = {"arm": "cross_silo_async_compressed", "wall_s": time.time() - t0,
                 "events": aj["events"], "late_staleness": aj["late_staleness"],
                 "flow_ids": aj["flows"], "wire_bytes_dense": aj["wire_bytes_dense"],
                 "wire_bytes_compressed": aj["wire_bytes_compressed"]}
    print(json.dumps(async_arm))
    if not (set(aj["flows"]["t"]) <= starts and set(aj["flows"]["f"]) <= starts
            and len(starts) == XS_ASYNC["events"] + 1):
        fail(f"cross_silo_async_compressed: flow ids do not pair {aj['flows']}")
    if not any(s > 0 for e in aj["events"] for s in e["staleness"]) and not any(
            s > 0 for s in aj["late_staleness"]):
        fail("cross_silo_async_compressed: the straggler's update never arrived stale")

    # tabular_alignment (its card-against-CPU run is in xs_card_vs_cpu)
    server, hist, wall = xs_tabular_job("cuda")
    last = hist[-1]
    tab = {"arm": "tabular_alignment", "wall_s": wall,
           "dims": [server.dimension_info["input_dimension"],
                    server.dimension_info["output_dimension"]],
           "eval_metrics": last.eval_metrics, "fit_losses": [r.fit_losses["backward"]
                                                             for r in hist]}
    print(json.dumps(tab))
    if not {"balanced_accuracy", "f1", "roc_auc"} <= set(last.eval_metrics) or not all(
            np.isfinite(v) for v in last.eval_metrics.values()):
        fail(f"tabular_alignment: eval metrics {last.eval_metrics}")

    launches = all_launches(fa, dp)
    if any(launches[k] for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")):
        fail(f"phase 41 launched K3-K5: {launches}")
    out = {"phase": "cross_silo", "wall_s": time.time() - t_phase, "framing": "native",
           "framing_build_s": build_s, "tiny_max_abs_err": tiny, "tiny_wall_s": tiny_wall,
           "arm_wall_s": {a["arm"]: a["wall_s"] for a in (fedprox, dp_arm, async_arm, tab)},
           "launches": launches}
    print(card_line())
    print(json.dumps(out))
    return out


def elapsed(t_start: float, after: str) -> None:
    """The script's wall so far, after a slice's phases (where its 1200 s
    go)."""
    print(json.dumps({"elapsed_s": time.time() - t_start, "after": after}))


def main() -> int:
    t_start = time.time()
    if sys.argv[1:] == ["--drill-child"]:
        return drill_child()
    if not torch.cuda.is_available():
        print("chip_smoke: needs an NVIDIA card; torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from fl4health_tpu_torch.kernels import dp_clip as dp
    # the module: the package exports the function of that name, as JAX's does
    fa = importlib.import_module("fl4health_tpu_torch.kernels.flash_attention")
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False  # and f32 convolutions too
    card = card_line()
    print(card)

    t0 = time.time()
    with ThreadPoolExecutor(2) as pool:  # each build compiles its sources in parallel
        for build in [pool.submit(m.build_extension) for m in (fa, dp)]:
            build.result()
    print(json.dumps({"build_s": time.time() - t0}))

    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        errs[dtype] = kernel_checks(fa, B, T, dtype, seed=1,
                                    autograd_check=dtype == torch.float32)
        kernel_checks(fa, 4, RAGGED_T, dtype, seed=2, autograd_check=True)
    # bf16 at head dim 12 (24-byte rows, no TMA stride): the CUDA-core route
    # through the wrapper and autograd
    kernel_checks(fa, 4, RAGGED_T, torch.bfloat16, seed=3, autograd_check=True, d=12)
    vmapped_errs = vmapped_kernel_checks(fa, seed=4)
    per_client_timings = kernel_timings(fa, torch.bfloat16)
    timings = kernel_timings(fa, torch.bfloat16, clients=N_CLIENTS)
    tiny_parity()
    bf16_model_check(fa)
    launches = main_path(fa)
    elapsed(t_start, "flash phases (1-5)")

    dp_errs = {dtype: dp_kernel_checks(dp, dtype)
               for dtype in (torch.float32, torch.bfloat16)}
    dp_timings = dp_kernel_timings(dp)
    batched_errs = {dtype: dp_batched_checks(dp, dtype)
                    for dtype in (torch.float32, torch.bfloat16)}
    batched_timings = dp_batched_timings(dp)
    tiny_dp_parity(dp)
    dp_launches = dp_main_path(dp)
    elapsed(t_start, "DP phases (6-8)")

    rng_card_check()
    tiny_client_dp_parity()
    vmap_vs_loop(fa, dp)
    client_dp_main_path(fa, dp)
    pipelined_launches = pipelined_dp_path(dp)["launches"]
    elapsed(t_start, "rng, client DP, client axis, pipeline (9-12)")

    tiny_algorithm_parity(dp)
    config2 = dirichlet_cifar_datasets()
    alg_main_path("scaffold", fa, dp, config2)
    alg_main_path("fedprox", fa, dp, config2)
    dp_scaffold_launches = dp_scaffold_main_path(dp)
    elapsed(t_start, "config 2 (13-16)")

    # config 3: K3-K5 at its shape (4 clients folded, T 128, 12 heads), the
    # tiny card-vs-CPU runs, the main path, and the precision policy's arms
    bert_shape = dict(batch=BATCH, t=BERT_CFG["max_len"],
                      h=BERT_CFG["n_heads"])
    t128_errs = vmapped_kernel_checks(fa, seed=5, n=BERT_CLIENTS, **bert_shape)
    t128 = kernel_timings(fa, torch.bfloat16, clients=BERT_CLIENTS, **bert_shape)
    tiny_bert_parity(fa)
    dropout_parity()
    bert_launches = bert_main_path(fa)
    precision_main_path(fa, dp)
    elapsed(t_start, "config 3, precision (17-20)")

    # config 5 and the chunked route: the aggregate above 32 clients, the
    # tiny card-vs-CPU nnU-Net runs, chunked against pipelined, the main path
    aggregate_64()
    tiny_nnunet_parity()
    chunked_vs_pipelined(dp)
    nnunet = nnunet_main_path(fa, dp)
    nnunet_launches = nnunet["launches"]
    # the checkpoint slice's inference phase, on the main path's network
    nnunet_inference(nnunet.pop("sim"))
    del nnunet
    torch.cuda.empty_cache()
    elapsed(t_start, "config 5 (21-24)")

    # the cohort slice: cohort slots over a registry, the compressed exchange
    tiny_cohort_parity()
    cohort = cohort_dp_cifar_cnn(fa, dp, cifar_pool())
    cohort_launches = cohort[f"n_{COHORT_SIZES[-1]}"]["launches"]
    cohort_chunked_vs_pipelined(cohort["sources"][COHORT_SIZES[0]])
    compressed_dp_cifar_cnn()
    elapsed(t_start, "cohort, compression (25-28)")

    # the async slice: buffered async (FedBuff) with the fault plan and
    # the robust aggregators, dense and over the registry
    tiny_async_parity()
    async_launches = async_dp_cifar_cnn(fa, dp)["launches"]
    async_cohort_launches = async_cohort_dp_cifar_cnn(
        fa, dp, cohort["sources"][COHORT_SIZES[0]])["launches"]
    elapsed(t_start, "async (29-31)")

    # the checkpoint slice: checkpoint and resume on every route, a card
    # frame resumed on the CPU; cuDNN deterministic in these phases only
    # (TF32 is off throughout)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    # the drills' 8 children start up now, beside the checkpoint phases
    children = DrillChildPool(8)
    try:
        ckpt = ckpt_dp_cifar_cnn(dp)
        ckpt_cohort = ckpt_cohort_dp_cifar_cnn(dp, cohort["sources"][COHORT_SIZES[0]])
        ckpt_async = ckpt_async_dp_cifar_cnn(dp)
        ckpt_card_to_cpu()
        elapsed(t_start, "checkpoints (32)")
        # the observability slice: on against off, the halt and its bundle,
        # the cohort's ledger and ring; then the checkpoint slice's SIGKILL
        # drill and this slice's SIGTERM drill, their children side by side
        obs = obs_dp_cifar_cnn(dp)
        obs_halt_bundle(dp)
        obs_cohort_dp_cifar_cnn(dp, cohort["sources"])
        drills(children)
        children.close()
        elapsed(t_start, "observability, the two drills (33)")
        # the recovery slice: the tiny drill card against CPU, the four DP
        # arms on both routes, the cohort's quarantine by registry id, the
        # server-lr rebind
        tiny_recovery_parity()
        recovery = recovery_dp_cifar_cnn(dp)
        recovery_cohort(dp, cohort["sources"][COHORT_SIZES[0]])
        hoisting_server_lr()
        elapsed(t_start, "recovery (34)")
        # the introspection and operations plane: on against off, the
        # counted flops against FlopCounterMode, the live retune drill
        ops = ops_dp_cifar_cnn(fa, dp)
        elapsed(t_start, "introspection, operations (35)")
        # the sweep slice: the 24-cell DP grid, Ditto and MR-MTL
        sweep = sweep_dp_cifar_cnn(dp)
        elapsed(t_start, "sweep, Ditto, MR-MTL (36)")
        # the split-model personalisation family: eleven arms at the DP
        # path's width, its tiny fixture card against CPU, PerFCL chunked
        pfl_cifar_cnn(fa, dp)
        elapsed(t_start, "split-model personalisation (37)")
        # the mesh slice: a one-rank NCCL world, three arms bit for bit
        # against their unsharded runs
        mesh = mesh_slice(fa, dp)
        elapsed(t_start, "mesh (38)")
        # the model-state slice: buffered async and the admin plane under
        # a one-rank NCCL mesh, FedPM's masked models, FedBN's statistics
        model_state = model_state_slice(fa, dp)
        elapsed(t_start, "model state, FedPM, FedBN, mesh async and admin (39)")
        # the algorithm-breadth slice: MK-MMD and deep MMD, Flash, FedDG-GA,
        # partial exchange, model merge and FedPCA
        breadth = breadth_slice(fa, dp)
        elapsed(t_start, "algorithm breadth (40)")
    finally:
        torch.backends.cudnn.deterministic = deterministic
        children.close()
    del cohort
    torch.cuda.empty_cache()
    # the cross-silo slice: the transport, the metrics and data tail,
    # feature alignment (the config-3 warm start runs in its main path)
    cross_silo = cross_silo_slice(fa, dp)
    elapsed(t_start, "cross-silo (41)")

    replaces = {"flash_fwd": "fl4health_tpu/kernels/flash_attention.py:71",
                "flash_bwd_dq": "fl4health_tpu/kernels/flash_attention.py:141",
                "flash_bwd_dkv": "fl4health_tpu/kernels/flash_attention.py:175"}
    kernels = []
    for name, rep in replaces.items():
        # at the shape of every main-path launch: both clients folded, the
        # mask a stack of their rows
        t, one = timings[name], per_client_timings[name]
        kernels.append({
            "name": name, "route": "cuda", "source": WGMMA_SOURCE, "replaces": rep,
            "design": "wgmma", "launches": launches[name],
            "max_abs_err": vmapped_errs["max_abs_err"][name],
            "bound_used": vmapped_errs["bound_used"][name],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound"][0],
            "bound_by": t["bound"][1], "library_ms": t["library_ms"],
            # one SDPA backward call, which computes dQ, dK and dV together
            **({"library_dqkv_ms": t["library_dqkv_ms"]} if "library_dqkv_ms" in t else {}),
            "dtype": "bfloat16", "shape": [N_CLIENTS * B, T, H, D], "mask_blocks": N_CLIENTS,
            # one client's batch [B, T, H, D], a [B, T] mask: the same
            # numbers, the f32 error, and the first slice's CUDA-core kernel
            # that this one replaces for bf16 (f32 still takes it), timed on
            # the same inputs, with its error there
            "per_client_shape": [B, T, H, D],
            "per_client_max_abs_err": errs[torch.bfloat16]["max_abs_err"][name],
            "per_client_max_abs_err_f32": errs[torch.float32]["max_abs_err"][name],
            "per_client_ms": one["ms"], "per_client_plain_ms": one["plain_ms"],
            "per_client_bound_ms": one["bound"][0], "per_client_library_ms": one["library_ms"],
            **({"per_client_library_dqkv_ms": one["library_dqkv_ms"]}
               if "library_dqkv_ms" in one else {}),
            "cuda_core_source": SOURCE, "cuda_core_ms": one["cuda_core_ms"],
            "cuda_core_max_abs_err": errs[torch.bfloat16]["max_abs_err"]["cuda_core"][name],
            # config 3 (bert_lora_fedopt_base): its launches, and the kernel at
            # its shape, 4 clients folded at T 128, 12 heads, bf16
            "launches_bert_lora_fedopt_base": bert_launches[name],
            # the mesh slice (phase 38): ZeRO-1 config 3 and the flash ring
            # over a one-rank NCCL world, 2 rounds each
            "launches_mesh_zero1_bert_lora_fedopt":
                mesh["bert"]["mesh_pipelined"]["launches"][name],
            "launches_ring_transformer_long": mesh["ring"]["mesh_pipelined"]["launches"][name],
            # the algorithm-breadth slice (phase 40): every arm, none
            "launches_algorithm_breadth": breadth["launches"][name],
            # the cross-silo slice (phase 41): none
            "launches_cross_silo": cross_silo["launches"][name],
            "launches_nnunet_fullres": nnunet_launches[name],
            "launches_cohort_dp_cifar_cnn": cohort_launches[name],
            "launches_async_dp_cifar_cnn": async_launches[name],
            "launches_async_cohort_dp_cifar_cnn": async_cohort_launches[name],
            "t128_shape": [BERT_CLIENTS * BATCH, BERT_CFG["max_len"], BERT_CFG["n_heads"], D],
            "t128_max_abs_err": t128_errs["max_abs_err"][name],
            "t128_bound_used": t128_errs["bound_used"][name],
            "t128_ms": t128[name]["ms"], "t128_plain_ms": t128[name]["plain_ms"],
            "t128_bound_ms": t128[name]["bound"][0], "t128_bound_by": t128[name]["bound"][1],
            "t128_library_ms": t128[name]["library_ms"],
            **({"t128_library_dqkv_ms": t128[name]["library_dqkv_ms"]}
               if "library_dqkv_ms" in t128[name] else {})})
    dp_replaces = {"dp_sq_norms": "fl4health_tpu/kernels/dp_clip.py:54",
                   "dp_scaled_sum": "fl4health_tpu/kernels/dp_clip.py:100"}
    dp_design = {"dp_sq_norms": "one launch over the tree: planned items, one CTA each "
                                "(narrow rows packed, wide rows cut; 4 loads in flight a "
                                "thread), last-CTA finish in a fixed order",
                 "dp_scaled_sum": "16-byte column groups, rows in order; rows split "
                                  "over threads on narrow leaves"}
    for name, rep in dp_replaces.items():
        t, tree = dp_timings["leaf"][name], dp_timings["tree"][name]
        bt, btree = batched_timings["leaf"][name], batched_timings["tree"][name]
        kernels.append({
            "name": name, "route": "cuda", "source": DP_SOURCE, "replaces": rep,
            "design": dp_design[name], "launches": dp_launches[name],
            # the early-stopped pipelined phase's own count (3 rounds)
            "launches_pipelined_dp_cifar_cnn": pipelined_launches[name],
            # DP-SCAFFOLD's: the warm start and 2 rounds
            "launches_dp_scaffold_cifar_cnn": dp_scaffold_launches[name],
            "launches_nnunet_fullres": nnunet_launches[name],
            # 3 warm rounds over the 100,000-client registry, 64 slots
            "launches_cohort_dp_cifar_cnn": cohort_launches[name],
            # 6 events (7 waves) of buffered async, and 4 over the registry
            "launches_async_dp_cifar_cnn": async_launches[name],
            "launches_async_cohort_dp_cifar_cnn": async_cohort_launches[name],
            # the checkpoint slice's resumed arms: rounds 3-4 (chunked),
            # cohort rounds 3-4, async events 4-6 (chunked, no prologue)
            "launches_ckpt_dp_cifar_cnn": ckpt["chunked"]["launches"]["resumed"][name],
            "launches_ckpt_cohort_dp_cifar_cnn": ckpt_cohort["launches"]["resumed"][name],
            "launches_ckpt_async_dp_cifar_cnn":
                ckpt_async["chunked"]["launches"]["resumed"][name],
            # the observability slice: 2 rounds with observability on
            # (chunked), equal to the off run's
            "launches_obs_dp_cifar_cnn": obs["chunked"]["launches"]["on"][name],
            # the recovery slice: the supervised faulted arm (chunked), every
            # round it dispatched, replays included
            "launches_recovery_dp_cifar_cnn":
                recovery["chunked"]["supervised"]["launches"][name],
            # the introspection and operations slice: 2 rounds with
            # introspection and the plane armed (pipelined), equal to off
            "launches_ops_dp_cifar_cnn": ops["introspection"]["launches"]["on"][name],
            # the sweep slice: the 24-cell grid, 2 rounds a cell (packed)
            "launches_sweep_dp_cifar_cnn": sweep["launches"][name],
            # the mesh slice (phase 38): MeshConfig() over a one-rank NCCL
            # world, 2 rounds a route
            "launches_mesh_dp_cifar_cnn": mesh["dp"]["mesh_pipelined"]["launches"][name],
            "launches_mesh_dp_cifar_cnn_chunked":
                mesh["dp"]["mesh_chunked"]["launches"][name],
            # the model-state slice (phase 39): buffered async (6 events) and
            # the armed admin plane (2 rounds) over a one-rank NCCL world
            "launches_mesh_async_dp_cifar_cnn":
                model_state["mesh_async"]["mesh_pipelined"]["launches"][name],
            "launches_mesh_async_dp_cifar_cnn_chunked":
                model_state["mesh_async"]["mesh_chunked"]["launches"][name],
            "launches_mesh_ops_dp_cifar_cnn": model_state["mesh_ops"]["mesh"]["launches"][name],
            "launches_algorithm_breadth": breadth["launches"][name],
            # the cross-silo slice (phase 41): its DP arm, 4 silos x 2 rounds
            "launches_cross_silo": cross_silo["launches"][name],
            "max_abs_err": dp_errs[torch.float32][name],
            "max_abs_err_bf16": dp_errs[torch.bfloat16][name],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound"][0],
            "bound_by": t["bound"][1], "library_ms": t["library_ms"],
            # the same over all 8 leaves of the CifarNet per-example tree
            # (K1: one call over the tree; K2: one call per leaf)
            "tree_ms": tree["ms"], "tree_plain_ms": tree["plain_ms"],
            "tree_bound_ms": tree["bound"][0], "tree_library_ms": tree["library_ms"],
            **({"tree_geometry": tree["geometry"]} if "geometry" in tree else {}),
            # the client-batched entry at the path's shapes, 64 clients: the
            # largest leaf [64, 32, 524288] and the tree (K1 one call, K2 one
            # a leaf); library: bmm (K2), vector_norm (K1)
            "batched_shape": [DP_CLIENTS, BATCH, 524288],
            "batched_max_abs_err": batched_errs[torch.float32][name],
            "batched_max_abs_err_bf16": batched_errs[torch.bfloat16][name],
            "batched_ms": bt["ms"], "batched_plain_ms": bt["plain_ms"],
            "batched_bound_ms": bt["bound"][0], "batched_library_ms": bt["library_ms"],
            "batched_tree_ms": btree["ms"], "batched_tree_plain_ms": btree["plain_ms"],
            "batched_tree_bound_ms": btree["bound"][0],
            "batched_tree_library_ms": btree["library_ms"],
            "dtype": "float32", "shape": [BATCH, 524288]})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
