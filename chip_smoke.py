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
     moves.
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
     bit; both routes' warm walls in turns.
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
     SIGKILL drill in child processes: straight, killed after round 2's
     frame, killed 4 KiB into round 3's write; the torn run's newest
     generation flipped; the resumed and the falling-back children's final
     params' bytes and loss history equal the straight child's),
     ``ckpt_cohort_dp_cifar_cnn`` (N 1,000, compression with error
     feedback, the chunked cohort route: bit-equal with every dirty row),
     ``ckpt_async_dp_cifar_cnn`` (resumed after event 3 of 6 on both async
     routes, the frames and the history bit-equal; a changed seed refused
     with JAX's message) and ``ckpt_card_to_cpu`` (a card frame resumed on
     the CPU within 5e-4 of the CPU's straight run).
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
import json
import math
import os
import signal
import statistics
import subprocess
import sys
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


def build_sim(modules, datasets, dtype, device, seed, attention_fn=None):
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
        seed=seed, device=device)


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


def build_dp_sim(data, dtype, device, noise_multiplier, seed,
                 input_shape=(32, 32, 3), batch=BATCH, local_steps=LOCAL_STEPS, **sim_kw):
    from fl4health_tpu_torch import optim
    from fl4health_tpu_torch.clients import engine
    from fl4health_tpu_torch.clients.instance_level_dp import InstanceLevelDpClientLogic
    from fl4health_tpu_torch.metrics import efficient
    from fl4health_tpu_torch.metrics.base import MetricManager
    from fl4health_tpu_torch.models.cnn import CifarNet
    from fl4health_tpu_torch.server.simulation import FederatedSimulation
    from fl4health_tpu_torch.strategies.fedavg import FedAvg

    logic = InstanceLevelDpClientLogic(
        engine.from_module(CifarNet(dtype=dtype, input_shape=input_shape)),
        engine.masked_cross_entropy, clipping_bound=DP_CLIP,
        noise_multiplier=noise_multiplier)
    return FederatedSimulation(
        logic=logic, tx=optim.sgd(0.05), strategy=FedAvg(), datasets=data,
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
                           local_steps=2)
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
    sim = build_dp_sim(data, torch.bfloat16, "cuda", DP_SIGMA, seed=0)
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
    sim = build_alg_sim("dp_scaffold", data, "cuda", local_steps=LOCAL_STEPS)
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
                      "wgmma_launches": wgmma}))
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
    routes' warm walls in turns."""
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
               "warm_walls": mode_walls(auto, COHORT_ROUNDS)}
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
# drill children run three at a time: each is deterministic on the card
# whatever else runs (a CPU run is not: its thread pools share the cores)
DRILL_WORKERS = 3
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


def ckpt_drill() -> dict:
    """``ckpt_drill``: the subprocess crash drill on the card, dp_cifar_cnn
    at 4 rounds on the chunked route (``drill_dp_cifar_cnn``), in two
    waves of children run side by side: a straight child, a child
    SIGKILLed right after round 2's frame publishes, and one SIGKILLed 4
    KiB into round 3's frame write (its ring keeps rounds 1 and 2); then
    that ring's newest generation flipped (``corrupt_newest_generation(
    mode="flip")``), and the child resumed from round 2 beside the one
    that falls back to round 1, ``fallback_skipped`` naming the damaged
    file. Both resumed children's final params' bytes
    and loss history equal the straight child's."""
    from fl4health_tpu_torch.resilience.recovery import corrupt_newest_generation, run_child

    root = ckpt_dir("drill")

    def spec(tag, ckpt, kill=None):
        return ({"factory_file": str(Path(__file__).resolve()),
                 "factory_name": "drill_dp_cifar_cnn", "n_rounds": CKPT_ROUNDS,
                 "ckpt_dir": os.path.join(root, ckpt), "out_dir": os.path.join(root, tag),
                 "kill": kill, "device": "cuda"}, os.path.join(root, f"{tag}.json"))

    def wave(*specs):
        t0 = time.time()
        with ThreadPoolExecutor(min(len(specs), DRILL_WORKERS)) as pool:
            res = [f.result() for f in [pool.submit(run_child, s, p, 600.0) for s, p in specs]]
        return res, time.time() - t0

    post = {"round": CKPT_KILL, "phase": "post_save"}
    torn = {"round": CKPT_KILL + 1, "phase": "mid_write", "byte_offset": 4096}
    (straight, killed, torn_child), w1 = wave(spec("straight", "straight_ckpt"),
                                              spec("killed", "drill_ckpt", post),
                                              spec("torn", "torn_ckpt", torn))
    damaged = corrupt_newest_generation(os.path.join(root, "torn_ckpt"), mode="flip")
    (resumed, fallback), w2 = wave(spec("resumed", "drill_ckpt"),
                                   spec("fallback", "torn_ckpt"))
    for name, res, code in (("straight", straight, 0), ("killed", killed, -signal.SIGKILL),
                            ("resumed", resumed, 0), ("torn", torn_child, -signal.SIGKILL),
                            ("fallback", fallback, 0)):
        if res.returncode != code:
            fail(f"ckpt_drill {name} child exited {res.returncode}, expected {code}: "
                 f"{res.stderr[-3000:]}")
            raise SystemExit(1)
    if killed.params_bytes is not None or torn_child.params_bytes is not None:
        fail("ckpt_drill: a killed child finished")
    out = {"phase": "ckpt_drill", "rounds": CKPT_ROUNDS, "route": "chunked",
           "kill_round": CKPT_KILL, "wave_s": [w1, w2], "damaged": damaged,
           "resumed_from": resumed.done["resume"], "fallback_from": fallback.done["resume"]}
    for name, res in (("resumed", resumed), ("fallback", fallback)):
        same = res.params_bytes == straight.params_bytes and res.history == straight.history
        out[f"{name}_equal"] = same
        if not same or [r["round"] for r in res.history] != list(range(1, CKPT_ROUNDS + 1)):
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
    drop_dirs(root)
    print(json.dumps(out))
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
        direct = model.apply(params, one[None], train=False)[0]["prediction"][0].float()
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
                pred = model.apply(params, vol[w][None], train=False)[0]["prediction"][0]
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



def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: needs an NVIDIA card; torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from fl4health_tpu_torch.kernels import dp_clip as dp
    from fl4health_tpu_torch.kernels import flash_attention as fa

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

    dp_errs = {dtype: dp_kernel_checks(dp, dtype)
               for dtype in (torch.float32, torch.bfloat16)}
    dp_timings = dp_kernel_timings(dp)
    batched_errs = {dtype: dp_batched_checks(dp, dtype)
                    for dtype in (torch.float32, torch.bfloat16)}
    batched_timings = dp_batched_timings(dp)
    tiny_dp_parity(dp)
    dp_launches = dp_main_path(dp)

    rng_card_check()
    tiny_client_dp_parity()
    vmap_vs_loop(fa, dp)
    client_dp_main_path(fa, dp)
    pipelined_launches = pipelined_dp_path(dp)["launches"]

    tiny_algorithm_parity(dp)
    config2 = dirichlet_cifar_datasets()
    alg_main_path("scaffold", fa, dp, config2)
    alg_main_path("fedprox", fa, dp, config2)
    dp_scaffold_launches = dp_scaffold_main_path(dp)

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

    # the cohort slice: cohort slots over a registry, the compressed exchange
    tiny_cohort_parity()
    cohort = cohort_dp_cifar_cnn(fa, dp, cifar_pool())
    cohort_launches = cohort[f"n_{COHORT_SIZES[-1]}"]["launches"]
    cohort_chunked_vs_pipelined(cohort["sources"][COHORT_SIZES[0]])
    compressed_dp_cifar_cnn()

    # the async slice: buffered async (FedBuff) with the fault plan and
    # the robust aggregators, dense and over the registry
    tiny_async_parity()
    async_launches = async_dp_cifar_cnn(fa, dp)["launches"]
    async_cohort_launches = async_cohort_dp_cifar_cnn(
        fa, dp, cohort["sources"][COHORT_SIZES[0]])["launches"]

    # the checkpoint slice: checkpoint and resume on every route, the
    # SIGKILL drill in subprocesses, a card frame resumed on the CPU;
    # cuDNN deterministic in these phases only (TF32 is off throughout)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        ckpt = ckpt_dp_cifar_cnn(dp)
        ckpt_drill()
        ckpt_cohort = ckpt_cohort_dp_cifar_cnn(dp, cohort["sources"][COHORT_SIZES[0]])
        ckpt_async = ckpt_async_dp_cifar_cnn(dp)
        ckpt_card_to_cpu()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    del cohort

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
