#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``fedml_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card and the CUDA
toolkit. Phases, in order; any failure exits non-zero before the last line:

1. the card's name and power limit (``nvidia-smi``);
2. build every kernel from the sources in the checkout (one nvcc per
   source, all started together; sm_90a), with the build time and the
   compiler's register/shared-memory/spill report; a spill in a
   tensor-core kernel, or a bf16 CUDA-core B1-B4 in the build, fails;
3. check each kernel against its plain PyTorch version on the card:
   B1 (fused conv block) at every ResNet-56 block geometry (batch 32) and
   the odd shapes of its parity tests; B2-B4 (flash attention forward, dQ,
   dK/dV) at the FedLLM round's shape, the 111M hot loop's, long context
   and the odd shapes of ``tests/test_llm.py`` (key-padding masks, rows
   with no live key, d 8/100/128 with ragged s); float32 and bfloat16,
   gradients included, and the autograd Function against dense attention;
4. time each kernel at the main paths' shapes (B2-B4 at the FedLLM
   round's and the hot loop's): the kernel with CUDA events around eager
   calls and as device time (calls captured in a CUDA graph, its replay
   timed with CUDA events), its plain version, the device time of one
   PyTorch library call for the same function (``library_ms``) and the
   bound; B1-B4 must run the kernel their dtype selects (the kernels in
   the captured graph);
5. tiny runs of both paths on the card against the same runs on the CPU
   (ResNet-20 FedAvg; the federated LoRA causal LM with flash attention),
   the captured local step against the eager loop on the card
   (ResNet-20, f32 with TF32 off and bf16; one capture for four clients),
   and resume parity: a ResNet-20 run of 4 rounds checkpointed every 2
   (the checkpoint cuts the 8-round block) against 2 rounds resumed to 4,
   the resumed simulator's step captured before it restores, bitwise;
6. the flagship benchmark (``bench.py``'s ``bench_flagship`` at full
   width: ResNet-56, synthetic CIFAR-10 50,000 / 1,000, 64 clients per
   round, bf16, fused conv block): the GPU engine's step captured, then
   one block of 2 rounds through ``run_rounds_fused`` in timing mode and
   one eval; the round's FLOPs and MFU; the SP golden loop for one round
   on 8 clients as the baseline; a ``{"flagship": ...}`` line. B1 held to
   27 launches per forward pass, counted through the graph's replays (its
   B1 nodes read from the graph's DOT dump), and one capture. After the
   timed block: the engine's state through ``RoundCheckpointer`` (bytes,
   seconds, restored bitwise), and ``save_model`` of its params served by
   ``CheckpointPredictor`` on the card: one batch of 32 test images
   bitwise equal to the engine's eval forward, 27 B1 launches;
7. the federated optimizer family: (a) each of the nine optimizers and
   FedOpt's adam, adagrad and yogi on ResNet-20 (f32, 2 rounds of 4 of 8
   clients) through the GPU engine (captured) against the SP loop (eager),
   cuDNN on deterministic algorithms, within a few ulps of the largest
   update (expected bitwise); (b) SCAFFOLD on the flagship's configuration
   (its step, the control-variate transform inside, captured apart; one
   timed block of 2 rounds, one eval), rounds/hour beside phase 6's
   FedAvg, B1 at 27 launches per forward, the bytes of the ``[64, ...]``
   client-state stack; (c) B1 against its plain version at the folded
   batch (64 x 32 = 2,048, bf16), then FedSGD on the flagship's shape
   (8,192 samples) for one round with ``client_slot_fold`` on and one with
   it off, their seconds and B1 launches, the folded aggregate held to
   the unfolded one; an ``{"optimizers": ...}`` line;
8. the defended round: (a) twelve ResNet-20 configurations (f32, 2
   rounds of 4 of 8 clients, cuDNN on deterministic algorithms: LDP, CDP
   gaussian and laplace, NbAFL, byzantine_flip + multi_krum,
   byzantine_random + rfa, label_flip + foolsgold, coordinate_median,
   trimmed_mean, bulyan, cclip, weak_dp): the fused path against the host
   path (params and verdicts) and the GPU engine against the SP loop
   (the configurations without a stochastic attack or defense), and the
   device ``normal`` against the host one at 855,770 draws (1 ulp); (b)
   the defended flagship: MAIN_PATH with 12 of 64 clients flipped x5 and
   multi-krum keeping 20, one timed block of 2 rounds on the fused path,
   1 round on the host path, 1 round of LDP; rounds/hour beside phase
   6's FedAvg, the device milliseconds of attack + defense + DP per round
   (CUDA events), the matrix bytes, B1 at 27 launches per forward with
   one capture, the verdicts excluding every flipped client; (c)
   ``bench_robust_krum`` and ``bench_robust_rfa`` at their own
   configuration (16 clients, lr, blocks of 8): fused and host
   rounds/hour, ``vs_baseline``, ``params_max_abs_diff``,
   ``verdicts_identical``; a ``{"robust": ...}`` line;
9. the round under faults and selection: (a) ResNet-20 runs (f32, 2-3
   rounds of 4 of 8 clients, cuDNN on deterministic algorithms): chaos
   (dropout and stragglers, tolerance on and off) on the card against
   the CPU within the house tolerance with the fault ledgers equal, and
   at probability 0 bitwise equal to a chaos-free run; oort,
   power-of-choice and reputation (beside byzantine_flip + multi_krum)
   with adaptive over-sampling on the host robust path, cohorts equal to
   the CPU run's round for round; LOO and GTG-Shapley fused against
   host, bitwise; a user ServerAggregator (the coordinate_median host
   kernel) against the built-in defense, bitwise; the int8 and bf16
   relayout under multi-krum, card against CPU (the defense's input
   level by level, then the run); a crash at round 1 of 3
   resumed to the end, bitwise; (b) MAIN_PATH at 64 of 128 clients: leg
   0 FedAvg, leg 1 bench_chaos_selection's knobs (20 % dropout, 10 %
   stragglers at half work, oort, adaptive over-sampling), one block of
   2 rounds each, leg 2 leg 1 with LOO for 1 round (the fused robust path
   pins the cohort): rounds/hour, cohorts, dropped and straggling counts,
   summed work, B1 at 27 launches per forward with one capture, a
   dropped client's empty slot, the oort store's clients equal to those
   that trained, the LOO values, seconds and evaluations (K + 1); a
   ``{"chaos_selection": ...}`` line;
10. buffered-async rounds (``round_mode: async_buffered``): (a) ResNet-20
   runs (f32, all 8 clients in flight, K 4, 3 pours after the bootstrap,
   ``bench_async_chaos``'s chaos, cuDNN on deterministic algorithms): the
   card against the CPU within the house tolerance with the pour records
   and the ledger equal, for FedAvg, SCAFFOLD and defended pours (krum,
   foolsgold) under byzantine_random x10; a crash at pour 1 of 3
   resumed to the end, bitwise; (b) MAIN_PATH at 64 of 128 clients in
   flight, K 32, ``bench_async_chaos``'s chaos: leg 1 the bootstrap then
   4 timed pours, leg 2 with ``bench_async_robust``'s attack (26 of 128
   byzantine_random x10) and krum, the bootstrap then 2 timed pours:
   seconds per pour, pours and updates per wall hour (beside phase 9's
   sync FedAvg at 64 of 128), updates per simulated hour, staleness,
   steps, dropped and straggling counts, B1 at 27 launches per forward
   with one capture, the defended pour's device ms, its matrix and ring
   bytes and every byzantine row excluded; an ``{"async": ...}`` line;
11. the FedLLM main path: ``fedml_tpu_torch.llm.run_federated_llm`` at
   ``bench.py``'s ``bench_federated_lora`` configuration (d 512, 4 layers,
   seq 256, bf16, LoRA r8, 2 silos, Shakespeare), 2 rounds with eval after
   each, its local step captured, B2 launches held to 4 per forward and
   B3/B4 to 4 per local step (warm-up steps and the export's eager
   personalisation steps included); the adapters exported
   (``llm_adapter_export_dir``: ``global``, ``silo_0``, ``silo_1``) and
   reloaded bitwise;
12. the serving path: the FedLLM main path's model, base weights frozen
   and the adapter the run of phase 11 trained, served through
   ``fedml_tpu_torch.serving.llm_template.CausalLMPredictor`` with
   ``bench.py``'s ``bench_llm_serving`` traffic (24 new tokens, concurrency
   1 / 8 / 64): single mode as the sequential baseline (B2 per layer per
   token), then batch mode (64 slots, paged KV cache) built from the
   exported artifacts (``CausalLMPredictor.from_artifact`` with
   ``llm_adapter_dir``; greedy tokens equal to a predictor built in
   memory from the run's adapters) with a bank of 1 adapter and of 64,
   and ``bench_llm_serving_adapter_churn``'s traffic (c64, 12 new
   tokens, 8 adapters, 4 rounds each re-exporting one adapter into the
   watched directory: 4 swaps, post-swap tokens equal a fresh
   predictor's); before it, the cache arithmetic against the CPU, decode
   against the full forward (f32 tiny, bf16 full width), greedy parity
   single vs batch on a full fine-tune, adapter isolation; a
   ``{"serving": ...}`` line;
13. the LLM hot loop: 4 SGD steps of the 111M causal LM (bs 8 x seq 1024,
   bf16, full parameters), 8 launches of each attention kernel per step;
   then ``save_model`` / ``load_model`` of its params (the codec's MB/s,
   round trip bitwise);
14. one JSON line describing each kernel, then the card line, then
    ``{"ok": true, "device": {...}}`` as the last line.

Each main path is driven with every launch count set to 0 just before it
and read just after. Imports nothing of JAX or ``fedml_tpu``.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

# H100 SXM published peaks (NVIDIA data sheet, dense): bf16 tensor cores,
# float32 outside them, and HBM3 bandwidth. Rates assume a 700 W limit.
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12

# ResNet-56 BasicBlock geometries at batch 32: (h, cin, cout, stride) and
# how many of the 27 blocks have each
FLAGSHIP = [((32, 16, 16, 1), 9), ((32, 16, 32, 2), 1), ((16, 32, 32, 1), 8),
            ((16, 32, 64, 2), 1), ((8, 64, 64, 1), 8)]
BATCH = 32
# the odd shapes of tests/test_conv_block.py and the batch that is not a
# multiple of its grid block: (n, h, w, cin, cout, stride)
ODD = [(2, 7, 9, 16, 16, 1), (2, 7, 7, 16, 32, 2), (2, 9, 8, 16, 32, 2),
       (2, 8, 8, 16, 32, 1), (11, 8, 8, 16, 16, 1)]

# Forward tolerances, |kernel - plain| <= atol + rtol * |plain|:
#  float32: the kernel and cuDNN (TF32 off) sum 144-576-term dot products
#  and 16k-element GroupNorm sums in different orders (~1e-6 relative);
#  bfloat16: the tensor-core kernel rounds y1 to bf16 once, as conv2's A
#  operand (as the plain version in bf16 does: its GroupNorm casts back to
#  x's type), keeps everything else f32 and rounds the output once. So it
#  is held to the plain version in f32 on the same bf16 inputs with y1
#  rounded at the same place (plain_block_y1_bf16), within one bf16
#  rounding (2^-8 relative) of the output.
FWD_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (8e-3, 2e-3)}
# bfloat16 B1 is also held to the plain version without that rounding, in
# f32 and in bf16, by its largest error relative to the largest output
# entry. f32: y1's rounding (2^-9 relative) carried through conv2 and GN2,
# plus the output's own rounding, stays within one bf16 ulp of the largest
# entry (2^-7). bf16: the plain version also rounds conv2's output, both
# GroupNorms' and the residual sum, so the two can differ by two ulps of
# the largest entry (2^-6).
B1_PLAIN_TOL = {"float32": 2 ** -7, "bfloat16": 2 ** -6}
# B1 at the folded round's batch (FOLD_BATCH, phase 7): 8.4-33.5 M outputs
# per geometry against 0.1-0.5 M at batch 32. FWD_TOL leaves out one term
# of the bf16 kernel's numerics: a y1 entry near a bf16 rounding midpoint
# may round the other way than in the plain version (another f32 sum
# order), which moves an output by ~1e-3 per such entry in its receptive
# field, whatever the output's size. On the card a few to a few tens of
# outputs per geometry (of millions) fall just outside FWD_TOL at that
# batch, where the output is small. So at that batch the elementwise bound
# adds y1_flip_bound (computed per output from the plain version); the
# count outside FWD_TOL alone is printed.
# Gradients: the kernel's backward recomputes the plain version, so the two
# differ only by the card's run-to-run summation order; error relative to
# the largest gradient entry.
GRAD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}

# The ResNet main path: bench.py's bench_flagship at full width (ResNet-56,
# CIFAR-10-shaped synthetic data 50,000 / 1,000, 64 clients per round,
# batch 32, bf16, lr 0.1, seed 0) with the fused conv block, in timing
# mode: one block of FLAGSHIP_BLOCK rounds through run_rounds_fused, then
# one eval.
MAIN_PATH = dict(
    backend="gpu", dataset="synthetic_cifar10", model="resnet56",
    precision="bfloat16", fused_conv_block="pallas", client_num_in_total=64,
    client_num_per_round=64, comm_round=1, epochs=1, batch_size=32,
    learning_rate=0.1, synthetic_size=50000, synthetic_test_size=1000,
    frequency_of_the_test=-1, random_seed=0, rounds_per_dispatch=8)
FLAGSHIP_BLOCK = 2
# bench_flagship's baseline: the golden loop (SP, eager local steps) on 8
# clients over 6,250 samples, one round, per-sample normalised
SP_BASELINE = dict(MAIN_PATH, backend="sp", client_num_in_total=8,
                   client_num_per_round=8, synthetic_size=6250,
                   max_total_samples=6250)
# The captured step against the eager loop on the card (phase 5): one
# ResNet-20 client's SGD steps (momentum 0.9, lr 0.01) from the same
# params; largest param difference over the largest param update. The two
# launch the same kernels, with cuDNN held to deterministic algorithms for
# the check, so they should agree bitwise; the bound allows a few f32
# ulps of reordering, and in bf16 a flipped rounding of a gradient entry
# (2^-8 of it).
CAPTURE_TOL = {"float32": 1e-3, "bfloat16": 2e-2}

# The FedLLM main path: bench.py's bench_federated_lora ("BASELINE.json
# config 4 as a federated round") at its full width, 2 rounds, eval after
# each.
LLM_MAIN_PATH = dict(
    dataset="llm", model="causal_lm", precision="bfloat16",
    client_num_in_total=2, client_num_per_round=2, comm_round=2, epochs=1,
    batch_size=8, learning_rate=1e-3, federated_optimizer="fedavg",
    frequency_of_the_test=1, random_seed=0,
    llm_corpus_fallback="shakespeare", llm_hidden_size=512,
    llm_intermediate_size=1408, llm_num_layers=4, llm_num_heads=8,
    llm_max_seq_len=256, lora_rank=8, llm_attention_impl="flash")
# Resume parity on the card (phase 5): tiny_run_agreement's ResNet-20 run
# at 4 rounds in timing mode, one 8-round block cut by a checkpoint every 2
RESUME = dict(dataset="synthetic_cifar10", model="resnet20",
              client_num_in_total=4, client_num_per_round=2, comm_round=4,
              batch_size=8, learning_rate=0.01, max_total_samples=64,
              synthetic_test_size=64, frequency_of_the_test=-1,
              random_seed=3, fused_conv_block="pallas",
              rounds_per_dispatch=8, checkpoint_every_rounds=2)
# The federated optimizer family (phase 7). (a) tiny_run_agreement's
# ResNet-20 run (fused conv block, f32) with 8 clients, 4 a round, 2 rounds
# (client state waits out a round), once per configuration through the GPU
# engine (captured) and once through the SP loop (eager), cuDNN on
# deterministic algorithms. Both run the same step and aggregation
# arithmetic, so they should agree bitwise; the bound is FAMILY_ULPS f32
# ulps of the largest update.
FAMILY_CFG = dict(
    dataset="synthetic_cifar10", model="resnet20", client_num_in_total=8,
    client_num_per_round=4, comm_round=2, batch_size=8, learning_rate=0.01,
    max_total_samples=64, synthetic_test_size=64, frequency_of_the_test=-1,
    random_seed=3, fused_conv_block="pallas")
FAMILY = {"FedAvg": {}, "FedProx": {}, "FedOpt": {},
          "FedOpt_adam": dict(server_optimizer="adam", server_lr=0.01),
          "FedOpt_adagrad": dict(server_optimizer="adagrad", server_lr=0.01),
          "FedOpt_yogi": dict(server_optimizer="yogi", server_lr=0.01),
          "FedSGD": dict(server_lr=0.1), "FedLocalSGD": {}, "SCAFFOLD": {},
          "FedNova": dict(momentum=0.9), "FedDyn": {}, "Mime": {}}
FAMILY_ULPS = 4
# (b) SCAFFOLD on the flagship's configuration (MAIN_PATH), its step
# captured apart, one timed block of FLAGSHIP_BLOCK rounds, one eval.
SCAFFOLD_PATH = dict(MAIN_PATH, federated_optimizer="SCAFFOLD")
# (c) FedSGD at the flagship's shape (ResNet-56, batch 32, bf16, fused conv
# block, 64 clients a round), the data cut from 50,000 to 8,192 samples so
# that one round with client_slot_fold off (64 clients x 7 padded batches
# = 448 passes at batch 32) and one with it on (7 passes at 64 x 32 =
# 2,048) fit the phase's time; both from the same seeded params.
FEDSGD_PATH = dict(MAIN_PATH, federated_optimizer="FedSGD", server_lr=0.1,
                   synthetic_size=8192)
FOLD_BATCH = FEDSGD_PATH["client_num_per_round"] * FEDSGD_PATH["batch_size"]
# The folded and the unfolded aggregate sum the same per-sample bf16
# gradients over batches of 2,048 and of 32: other cuDNN algorithms, other
# B1 cluster splits, other reduction orders. Bound: the largest difference
# within 2^-6 of the largest aggregate entry (a few bf16 roundings).
FOLD_TOL = 2.0 ** -6

# The defended round (phase 8). (a) FAMILY_CFG's ResNet-20 run (f32, 2
# rounds of 4 of 8 clients, cuDNN on deterministic algorithms) under each
# configuration below: the fused path (the one-card sharded kernels, no
# read-back inside a block) against the host path (a verdict read each
# round; same kernels, so bitwise expected, within ROBUST_ULPS ulps of the
# largest update), and the engine against the SP loop (the host kernels)
# for the configurations whose noise both draw alike: DP's is keyed
# alike, a stochastic attack's or defense's folds the shard index in on
# the engine only. The sharded and host kernels compute norms and krum's
# scores in other float32 orders (FoolsGold's logit magnifies that), so
# engine vs SP is held to ROBUST_SP_TOL of the largest update.
ROBUST_DP = dict(dp_epsilon=10.0, dp_delta=1e-5, dp_clip_norm=1.0)
ROBUST = {
    "ldp_gaussian": dict(enable_dp=True, dp_type="local_dp", **ROBUST_DP),
    "cdp_gaussian": dict(enable_dp=True, dp_type="central_dp", **ROBUST_DP),
    "cdp_laplace": dict(enable_dp=True, dp_type="central_dp",
                        dp_mechanism="laplace", **ROBUST_DP),
    "nbafl": dict(enable_dp=True, dp_type="nbafl", **ROBUST_DP),
    "flip_multi_krum": dict(enable_attack=True, attack_type="byzantine_flip",
                            byzantine_client_num=1, attack_scale=5.0,
                            enable_defense=True, defense_type="multi_krum",
                            krum_param_m=2),
    "random_rfa": dict(enable_attack=True, attack_type="byzantine_random",
                       byzantine_client_num=1, enable_defense=True,
                       defense_type="rfa"),
    "label_flip_foolsgold": dict(enable_attack=True, attack_type="label_flip",
                                 byzantine_client_num=2, enable_defense=True,
                                 defense_type="foolsgold"),
    "coordinate_median": dict(enable_defense=True,
                              defense_type="coordinate_median"),
    "trimmed_mean": dict(enable_defense=True, defense_type="trimmed_mean",
                         beta=0.25),
    "bulyan": dict(enable_defense=True, defense_type="bulyan",
                   byzantine_client_num=1),
    "cclip": dict(enable_defense=True, defense_type="cclip", tau=0.05),
    "weak_dp": dict(enable_defense=True, defense_type="weak_dp"),
}
ROBUST_STOCHASTIC = ("random_rfa", "weak_dp")
ROBUST_ULPS = 4
ROBUST_SP_TOL = 1e-3
# the LDP noise of one flagship client: ResNet-56's parameter count
FLAGSHIP_PARAMS = 855770
# (b) the defended flagship: MAIN_PATH with bench_robust_krum's knobs
# scaled to 64 clients (12 flipped x5, multi-krum keeping 20); legs: the
# fused path for FLAGSHIP_BLOCK rounds, the host path for 1, and LDP
# (gaussian, epsilon 10, delta 1e-5, clip 1.0) for 1 (2 put the phase
# at 148 s, over its ~120 s share of the run).
ROBUST_FLAGSHIP = dict(MAIN_PATH, enable_attack=True,
                       attack_type="byzantine_flip", byzantine_client_num=12,
                       attack_scale=5.0, enable_defense=True,
                       defense_type="multi_krum", krum_param_m=20)
ROBUST_LEGS = (("fused", ROBUST_FLAGSHIP, FLAGSHIP_BLOCK),
               ("host", dict(ROBUST_FLAGSHIP, robust_fused="host"), 1),
               ("ldp", dict(MAIN_PATH, enable_dp=True, dp_type="local_dp",
                            dp_mechanism="gaussian", **ROBUST_DP), 1))
# (c) bench.py's bench_robust_krum and bench_robust_rfa at their own
# configuration: 16 clients of synthetic MNIST, logistic regression, 3
# flipped x5; a warm-up block of ROBUST_BENCH_BLOCK rounds, then two timed
# blocks per leg (fused, host), the best per-round time of each.
ROBUST_BENCH = dict(backend="gpu", dataset="synthetic_mnist", model="lr",
                    client_num_in_total=16, client_num_per_round=16,
                    comm_round=24, epochs=1, batch_size=32,
                    learning_rate=0.1, frequency_of_the_test=10_000,
                    random_seed=0, enable_attack=True,
                    attack_type="byzantine_flip", byzantine_client_num=3,
                    attack_scale=5.0, enable_defense=True)
ROBUST_BENCH_BLOCK = 8
ROBUST_BENCHES = {
    "fedavg_robust_krum_rounds_per_hour": dict(defense_type="multi_krum",
                                               krum_param_m=5),
    "fedavg_robust_rfa_rounds_per_hour": dict(defense_type="rfa")}

# The round under faults and selection (phase 9). (a) FAMILY_CFG's ResNet-20
# run (f32, cuDNN on deterministic algorithms): chaos (a quarter of the
# clients dropped, a quarter straggling at half their steps), tolerance on
# and off, on the card against the same run on the CPU within the house
# tolerance (HOUSE_TOL, |card - cpu| <= atol + rtol |cpu|), ledgers equal;
# the chaos knobs at probability 0 with the plan built (a crash round past
# the run) bitwise equal to a chaos-free run; three strategies with adaptive
# over-sampling on the host robust path (reputation beside a flip attack
# and multi-krum on 2 of 8), blocks of 1 round, their cohorts equal to the
# CPU run's round for round; LOO and GTG fused against host, bitwise; a
# user ServerAggregator that calls the coordinate_median host kernel
# against the built-in defense on the host kernels, bitwise; the int8 and
# bf16 relayout under multi-krum, card against CPU within the house
# tolerance plus one quantum of the matrix (an entry within float32
# rounding of a rounding boundary lands on the neighbouring level on one
# side: largest entry / 127 for int8, 2^-8 of it for bf16), its defense
# input the rounding of its own rows bitwise and round 0's within
# RELAYOUT_FLIP_SHARE of the CPU's levels; a crash at round 1 of 3
# (checkpoint every round) resumed to the end, bitwise.
HOUSE_TOL = (2e-4, 2e-5)
FAULTS_CHAOS = dict(chaos_dropout_prob=0.25, chaos_straggler_prob=0.25,
                    chaos_straggler_work=0.5, chaos_seed=5)
FAULTS_SELECTION = {
    "oort": dict(client_selection="oort"),
    "power_of_choice": dict(client_selection="power_of_choice"),
    "reputation": dict(client_selection="reputation", enable_attack=True,
                       attack_type="byzantine_flip", byzantine_client_num=2,
                       attack_scale=5.0, enable_defense=True,
                       defense_type="multi_krum", krum_param_m=4)}
FAULTS_SELECTION_CFG = dict(comm_round=3, rounds_per_dispatch=1,
                            selection_adaptive_oversample=True,
                            robust_fused="host")
RELAYOUT_QUANTUM = {"int8": 1.0 / 127.0, "bf16": 2.0 ** -8}
# the share of round 0's quantized entries that may sit on another level,
# card vs CPU: an update entry within the two devices' float32 gap of a
# rounding boundary
RELAYOUT_FLIP_SHARE = 0.01
# (b) the full-width leg: MAIN_PATH at partial participation (128 clients,
# 64 a round: bench_chaos_selection's "half of the clients per round" at
# the flagship's width). Leg 0 FedAvg, one block of FLAGSHIP_BLOCK rounds;
# leg 1 bench_chaos_selection's knobs (20 % dropout, 10 % stragglers at
# half work, seed 7, tolerance on, oort, adaptive over-sampling capped at
# 1.0), one block of FLAGSHIP_BLOCK rounds; leg 2 leg 1 with LOO, 1 round
# (the fused robust path pins the adaptive cohort at 64).
FAULTS_PATH = dict(MAIN_PATH, client_num_in_total=128,
                   client_num_per_round=64)
FAULTS_KNOBS = dict(chaos_dropout_prob=0.2, chaos_straggler_prob=0.1,
                    chaos_straggler_work=0.5, chaos_seed=7,
                    chaos_tolerance=True, client_selection="oort",
                    selection_adaptive_oversample=True,
                    selection_max_over_sample=1.0)
FAULTS_LEGS = (("fedavg", FAULTS_PATH, FLAGSHIP_BLOCK),
               ("chaos_oort", dict(FAULTS_PATH, **FAULTS_KNOBS),
                FLAGSHIP_BLOCK),
               ("chaos_oort_loo", dict(FAULTS_PATH, contribution_method="loo",
                                       **FAULTS_KNOBS), 1))

# Buffered-async rounds (phase 10). (a) FAMILY_CFG's ResNet-20 run (f32,
# cuDNN on deterministic algorithms) in round_mode async_buffered: all 8
# clients in flight, K 4 (half the concurrency), 3 pours after the
# bootstrap, bench_async_chaos's chaos (10 % dropout, 20 % stragglers whose
# full work arrives at 0.4 speed, seed 7); the card against the CPU within
# HOUSE_TOL with the history's poured / staleness / virtual_t and the
# ledger's pour records equal: FedAvg, SCAFFOLD (its extras ride the
# buffer), and defended pours under byzantine_random x10 on 2 of 8 with
# krum and foolsgold (stateful; verdicts within 1e-3); a crash at pour 1
# of 3 (checkpoint every pour) resumed to the end, bitwise.
ASYNC_CHAOS = dict(chaos_dropout_prob=0.1, chaos_straggler_prob=0.2,
                   chaos_straggler_work=0.4, chaos_seed=7)
ASYNC_CFG = dict(FAMILY_CFG, client_num_per_round=8, comm_round=3,
                 round_mode="async_buffered", async_buffer_k=4,
                 **ASYNC_CHAOS)
ASYNC_BYZ = dict(enable_attack=True, attack_type="byzantine_random",
                 attack_scale=10.0, byzantine_client_num=2)
ASYNC_CHECKS = {
    "fedavg": {}, "scaffold": dict(federated_optimizer="SCAFFOLD"),
    "krum": dict(ASYNC_BYZ, enable_defense=True, defense_type="krum"),
    "foolsgold": dict(ASYNC_BYZ, enable_defense=True,
                      defense_type="foolsgold")}
# (b) the full-width legs on FAULTS_PATH (ResNet-56, synthetic CIFAR-10
# 50,000, bf16, fused conv block, 128 clients, batch 32) with 64 clients in
# flight and K 32 under bench_async_chaos's chaos. Leg 1: the bootstrap (64
# clients), then 4 timed pours. Leg 2: leg 1 plus bench_async_robust's
# attack scaled to 128 clients (byzantine_random x10 on 26, its 20 %) and
# krum; the bootstrap, then 2 timed pours.
ASYNC_PATH = dict(FAULTS_PATH, round_mode="async_buffered",
                  async_buffer_k=32, **ASYNC_CHAOS)
ASYNC_LEGS = (("async", ASYNC_PATH, 4),
              ("async_krum", dict(ASYNC_PATH, enable_attack=True,
                                  attack_type="byzantine_random",
                                  attack_scale=10.0, byzantine_client_num=26,
                                  enable_defense=True, defense_type="krum"),
               2))

# The FedLLM hot loop: bench.py's _llm_train_step_timing model (~111M
# params) at bench_llm_mfu's bs 8 x seq 1024, bf16, flash attention.
HOT_LOOP = dict(vocab_size=8192, hidden_size=1024, intermediate_size=2816,
                num_layers=8, num_heads=8, max_seq_len=1024,
                dtype="bfloat16", attention_impl="flash")
HOT_BATCH, HOT_STEPS = 8, 4
# The serving path: bench.py's bench_llm_serving traffic on the FedLLM main
# path's model (its prompts, 24 new tokens, concurrency 1/8/64, a bank of
# 1 and of 64 adapters; 64 slots, blocks of 16, prefill chunks of 32).
SERVE_MAX_NEW = 24
SERVE_CONC = (1, 8, 64)
# bank rows: the zero row, the exported global / silo_0 / silo_1, the
# artifact's own "default" and 64 more (silo_0 and silo_1 re-added in place)
SERVE_BATCH = {"slots": 64, "block_size": 16, "prefill_chunk": 32,
               "max_adapters": 68, "request_timeout_s": 600.0}
# the same options as from_artifact reads them from the config
SERVE_ARGS = dict(llm_serving_mode="batch", serving_slots=64,
                  serving_kv_block_size=16, serving_prefill_chunk=32,
                  serving_max_adapters=68, serving_request_timeout_s=600.0)
# bench.py's bench_llm_serving_adapter_churn traffic: concurrency 64, 12
# new tokens, greedy, a bank of 8 named adapters, 4 rounds each
# re-exporting one adapter into the directory watch_dir polls every 0.1 s;
# here on the FedLLM main path's model (d 512), wider than the bench's d
# 128, so the swap is measured at the main path's width
CHURN = {"concurrency": 64, "max_new": 12, "bank": 8, "rounds": 4,
         "poll_s": 0.1}
SERVE_PROMPTS = [f"request {i}: summarize federated round {i * 7}"
                 for i in range(max(SERVE_CONC))]
# tests/test_serving_batch.py's TestKVParity prompts
PARITY_PROMPTS = ["add 2 3", "echo hello world", "x",
                  "subtract 19 4 and then explain"]
# Decode step vs the full forward at the same position, error relative to
# the row's largest logit. f32 (dense, TF32 off): both sum the same terms
# in different orders and shapes. bf16 at full width: single mode merges
# the adapter into W before the bf16 cast and its flash forward (B2) rounds
# P to bf16, the decode step keeps the adapter factored in f32 and its
# attention in f32; the two differ by a few bf16 roundings through four
# layers.
DECODE_TOL = {"float32": 1e-5, "bfloat16": 3e-2}
# single vs batch greedy on a full fine-tune may part only where the single
# path's top two logits are closer than this
TIE_GAP = 1e-4

# Attention shapes (b, s, h, d, mask): the FedLLM round (no key mask, as
# the trainer calls the model), the hot loop, bench_long_context, and the
# odd shapes of tests/test_llm.py and tests/test_torch_attention.py:
# random key padding, and masked prefixes that leave rows with no live key
# (within one 64-row tile and across tiles).
ATTN_MAIN = (8, 256, 8, 64, "none")
ATTN_HOT = (8, 1024, 8, 128, "none")
ATTN_SHAPES = [ATTN_MAIN, ATTN_HOT, (1, 4096, 8, 128, "none"),
               (2, 16, 2, 8, "none"), (2, 32, 2, 8, "random"),
               (1, 16, 1, 8, "prefix4"), (2, 100, 2, 8, "random"),
               (2, 100, 2, 8, "prefix4"), (2, 200, 2, 64, "prefix70"),
               (2, 200, 2, 128, "prefix70"), (1, 130, 3, 100, "random")]
# Attention tolerances. Error relative to the largest entry of the plain
# result (sums over up to s terms of either sign): float32 within f32
# reordering; bfloat16 within one rounding of the largest entry. Gradients
# in both dtypes, and O in bfloat16: the tensor-core forward rounds P to
# bf16 before P.V (as FlashAttention-2/3 do), so an entry of O carries the
# rounding of its weights (2^-9 relative each) besides its own, and a small
# entry can be off by more than its own ulp.
ATTN_GRAD_TOL = {"float32": 1e-4, "bfloat16": 8e-3}
# O in float32, elementwise |kernel - plain| <= atol + rtol*|plain|: both
# sum in f32 in different orders (~1e-6 relative). LSE is f32 in both
# dtypes and held the same way.
ATTN_FWD_TOL = (1e-4, 1e-5)
ATTN_LSE_TOL = (1e-5, 1e-5)
# The CUDA kernel each wrapper launches, by dtype.
KERNEL_NAME = {
    "bfloat16": {"fwd": "flash_fwd_mma_kernel", "dq": "flash_dq_mma_kernel",
                 "dkv": "flash_dkv_mma_kernel"},
    "float32": {"fwd": "flash_fwd_kernel", "dq": "flash_dq_kernel",
                "dkv": "flash_dkv_kernel"}}
B1_KERNEL_NAME = {"bfloat16": "conv_block_mma_kernel",
                  "float32": "conv_block_kernel"}
# What each kernel of the {"kernels": [...]} line is built from.
DESIGN = {
    "conv_block": "bf16: mma.sync m16n8k16 implicit GEMM + ldmatrix, a "
                  "thread-block cluster per sample (a band of rows per "
                  "CTA), GroupNorm and conv2's halo across the cluster "
                  "through distributed shared memory; f32: SIMT, one CTA "
                  "per sample",
    "flash_fwd": "bf16: mma.sync m16n8k16 + ldmatrix + cp.async 2-stage "
                 "ring; f32: SIMT",
    "flash_dq": "bf16: mma.sync m16n8k16 + ldmatrix + cp.async 2-stage "
                "ring, keys 32 at a time; f32: SIMT",
    "flash_dkv": "bf16: mma.sync m16n8k16 + ldmatrix + cp.async 2-stage "
                 "ring; f32: SIMT"}


class SmokeFailure(Exception):
    pass


def require(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card_line(query: str = "name,power.limit") -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def card_state() -> str:
    """The card's SM clock, power draw and temperature now (read right
    after a timed block, so blocks timed at other points of a run can be
    set side by side)."""
    return card_line("clocks.sm,power.draw,temperature.gpu")


def make_block(torch, gen, n, h, w, cin, cout, stride, dtype, device):
    """Random input and block params (the parity tests' scales), drawn on
    the CPU from ``gen`` and moved to ``device``."""
    def rnd(*shape, scale=1.0, shift=0.0):
        return (torch.randn(*shape, generator=gen) * scale + shift).to(
            device, dtype)

    p = {"w1": rnd(3, 3, cin, cout, scale=0.2),
         "g1_scale": rnd(cout, scale=0.1, shift=1.0),
         "g1_bias": rnd(cout, scale=0.1),
         "w2": rnd(3, 3, cout, cout, scale=0.2),
         "g2_scale": rnd(cout, scale=0.1, shift=1.0),
         "g2_bias": rnd(cout, scale=0.1)}
    if stride != 1 or cin != cout:
        p.update(wp=rnd(1, 1, cin, cout, scale=0.2),
                 gp_scale=rnd(cout, scale=0.1, shift=1.0),
                 gp_bias=rnd(cout, scale=0.1))
    return rnd(n, h, w, cin), p


def plain_block_y1_bf16(torch, cb, x, p, s, groups=8):
    """``reference_block`` in f32 with y1 rounded to bf16 before conv2: the
    plain version of the bf16 kernel's numerics."""
    y = cb._conv_same(x, p["w1"], s)
    y = torch.relu(cb._group_norm(y, p["g1_scale"], p["g1_bias"], groups,
                                  cb.GN_EPS))
    y = cb._conv_same(y.bfloat16().float(), p["w2"], 1)
    y = cb._group_norm(y, p["g2_scale"], p["g2_bias"], groups, cb.GN_EPS)
    r = x
    if "wp" in p:
        r = cb._group_norm(cb._conv_same(x, p["wp"], s), p["gp_scale"],
                           p["gp_bias"], groups, cb.GN_EPS)
    return torch.relu(r + y)


def y1_flip_bound(torch, cb, x, p, s, groups=8):
    """How far the bf16 kernel's output may move from
    ``plain_block_y1_bf16`` because a y1 entry rounds to the other bf16
    neighbour: the kernel's conv1 and GN1 sum in another f32 order, so an
    entry within max(1/64 of its bf16 ulp, 2^-16) of a rounding midpoint
    may round either way (f32 reordering moves y1 by ~1e-6 of its terms'
    size: 30-100x less). Each such entry moves conv2's output by at most
    ``|w2| * ulp``; summed over the receptive field and scaled by GN2's
    ``rstd * |scale|`` (its statistics over 16k entries move negligibly),
    per output."""
    y = cb._conv_same(x, p["w1"], s)
    y1 = torch.relu(cb._group_norm(y, p["g1_scale"], p["g1_bias"], groups,
                                   cb.GN_EPS))
    r = y1.bfloat16().float()
    ulp = torch.ldexp(torch.ones_like(r), torch.frexp(r)[1] - 8)
    near = ((y1 - r).abs() - ulp / 2).abs() <= torch.clamp(ulp / 64,
                                                           min=2.0 ** -16)
    z = cb._conv_same(r, p["w2"], 1)
    n, h, w, c = z.shape
    zg = z.reshape(n, h, w, groups, c // groups)
    var = (zg.square().mean(dim=(1, 2, 4), keepdim=True)
           - zg.mean(dim=(1, 2, 4), keepdim=True).square()).clamp(min=0.0)
    dz = cb._conv_same(near * ulp, p["w2"].abs(), 1).reshape(zg.shape)
    return (dz * torch.rsqrt(var + cb.GN_EPS)).reshape(z.shape) * p[
        "g2_scale"].abs()


def check_case(torch, cb, gen, shape, dtype, flips=False):
    """Forward and gradients of the kernel against the plain version.
    Returns (max abs forward error against the plain version in f32, max
    relative gradient error, and for bf16 the max abs error against the
    plain version in bf16, else None). ``flips`` (bf16): add
    :func:`y1_flip_bound` to the elementwise tolerance (B1 at the folded
    batch; see above B1_PLAIN_TOL)."""
    n, h, w, cin, cout, s = shape
    dt = getattr(torch, dtype)
    if dtype == "bfloat16":
        # the wrapper's footprint is the kernel's (csrc band_layout)
        k = cb.cluster_for(n, h, w, cout, s)
        need = cb._lib().conv_block_mma_smem_bytes(h, w, cin, cout, s, k)
        require(need == cb.smem_bytes(h, w, cin, cout, s, 8, dt, k),
                f"{shape}: the kernel needs {need} bytes of shared memory, "
                f"the wrapper reckons "
                f"{cb.smem_bytes(h, w, cin, cout, s, 8, dt, k)}")
    x, p = make_block(torch, gen, n, h, w, cin, cout, s, dt, "cuda")
    out = cb.fused_block(x, p, strides=s, groups=8)
    torch.cuda.synchronize()
    require(out.dtype == dt and tuple(out.shape) == (
        n, -(-h // s), -(-w // s), cout), f"{shape} {dtype}: bad output")
    # fixed reduction orders (in bf16 across the cluster too): a second
    # launch gives the same bits
    require(torch.equal(out, cb.fused_block(x, p, strides=s, groups=8)),
            f"{shape} {dtype}: two launches differ")
    xf, pf = x.float(), {k: v.float() for k, v in p.items()}
    ref = cb.reference_block(xf, pf, strides=s, groups=8)
    err = (out.float() - ref).abs()
    require(torch.isfinite(out.float()).all().item(),
            f"{shape} {dtype}: non-finite output")
    rtol, atol = FWD_TOL[dtype]
    err16 = None
    if dtype == "bfloat16":
        ref_y1 = plain_block_y1_bf16(torch, cb, xf, pf, s)
        e = (out.float() - ref_y1).abs()
        tol = atol + rtol * ref_y1.abs()
        if flips:
            print(f"  {shape}: {int((e > tol).sum())} of {e.numel()} "
                  f"outputs beyond FWD_TOL alone", flush=True)
            tol = tol + y1_flip_bound(torch, cb, xf, pf, s)
        bad = int((e > tol).sum())
        require(bad == 0, f"{shape} {dtype}: {bad} outputs beyond tolerance "
                          f"of the plain version with y1 in bf16 (max abs "
                          f"err {e.max().item():.3e})")
        ref16 = cb.reference_block(x, p, strides=s, groups=8).float()
        err16 = (out.float() - ref16).abs().max().item()
        for name, r, e in (("float32", ref, err.max().item()),
                           ("bfloat16", ref16, err16)):
            rel = e / r.abs().max().item()
            require(rel <= B1_PLAIN_TOL[name],
                    f"{shape} {dtype}: off the plain version in {name} by "
                    f"{rel:.3e} of its largest entry")
    else:
        bad = int((err > atol + rtol * ref.abs()).sum())
        require(bad == 0, f"{shape} {dtype}: {bad} outputs beyond tolerance "
                          f"(max abs err {err.max().item():.3e})")
    cot = torch.randn(out.shape, generator=gen).to("cuda")
    grads = []
    for fn in (cb.fused_block, cb.reference_block):
        leaves = [x.detach().clone().requires_grad_()] + [
            v.detach().clone().requires_grad_() for v in p.values()]
        o = fn(leaves[0], dict(zip(p, leaves[1:])), strides=s, groups=8)
        grads.append(torch.autograd.grad((o.float() * cot).sum(), leaves))
    gerr = max(((a.float() - b.float()).abs().max() /
                b.float().abs().max().clamp(min=1e-30)).item()
               for a, b in zip(*grads))
    require(gerr <= GRAD_TOL[dtype],
            f"{shape} {dtype}: gradient error {gerr:.3e}")
    return err.max().item(), gerr, err16


def time_ms(torch, fn, iters=50, warmup=5):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def library_block(torch, F, x_nchw, w, s, groups, eps):
    """The unfused cuDNN chain on channels-last NCHW tensors: conv2d,
    group_norm, relu, conv2d, group_norm, (conv2d, group_norm), add, relu.
    Padding is torch's symmetric padding=1 (the yardstick's timing does not
    depend on which side pads)."""
    y = F.conv2d(x_nchw, w["w1"], stride=s, padding=1)
    y = torch.relu(F.group_norm(y, groups, w["g1_scale"], w["g1_bias"], eps))
    y = F.conv2d(y, w["w2"], padding=1)
    y = F.group_norm(y, groups, w["g2_scale"], w["g2_bias"], eps)
    r = x_nchw
    if "wp" in w:
        r = F.conv2d(x_nchw, w["wp"], stride=s)
        r = F.group_norm(r, groups, w["gp_scale"], w["gp_bias"], eps)
    return torch.relu(r + y)


def block_cost(n, h, cin, cout, s, itemsize):
    """(bytes, ops) one block must move and do: x, every param and the
    output once each; the conv multiply-adds (2 ops each) plus ~7 ops per
    element for each GroupNorm and 1 each for the ReLUs and the add."""
    ho = -(-h // s)
    proj = s != 1 or cin != cout
    params = 9 * cin * cout + 9 * cout * cout + 4 * cout + (
        cin * cout + 2 * cout if proj else 0)
    nbytes = itemsize * (n * h * h * cin + n * ho * ho * cout + params)
    elems = n * ho * ho * cout
    macs = elems * (9 * cin + 9 * cout + (cin if proj else 0))
    ops = 2 * macs + elems * (7 * (3 if proj else 2) + 3)
    return nbytes, ops


def time_geometries(torch, F, cb, gen, dtype):
    """Per-geometry ms at batch 32: the kernel (CUDA events, and device
    time), its plain version, the unfused cuDNN chain (device time as
    ``library_ms``, and CUDA events) and the bound."""
    dt = getattr(torch, dtype)
    rows = []
    for (h, cin, cout, s), count in FLAGSHIP:
        x, p = make_block(torch, gen, BATCH, h, h, cin, cout, s, dt, "cuda")
        x_nchw = x.permute(0, 3, 1, 2)  # channels-last memory, no copy
        w = {k: (v.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last) if v.dim() == 4 else v)
            for k, v in p.items()}

        def kernel():
            return cb.fused_block(x, p, strides=s)

        def chain():
            return library_block(torch, F, x_nchw, w, s, 8, cb.GN_EPS)

        with torch.no_grad():
            k_ms = time_ms(torch, kernel)
            k_dev, names = device_ms(torch, kernel)
            p_ms = time_ms(torch, lambda: cb.reference_block(x, p,
                                                             strides=s))
            l_ms = time_ms(torch, chain)
            l_dev, _ = device_ms(torch, chain)
        # one kernel per dtype: bf16 B1 is the tensor-core cluster kernel
        want = B1_KERNEL_NAME[dtype]
        require(any(want in n for n in names) and not any(
            "conv_block" in n and want not in n for n in names),
            f"conv_block in {dtype} ran {names}, not {want}")
        nbytes, ops = block_cost(BATCH, h, cin, cout, s, x.element_size())
        t_bytes = nbytes / PEAK_BYTES * 1e3
        t_ops = ops / PEAK_OPS[dtype] * 1e3
        rows.append(dict(geometry=f"{h}x{h}x{cin}->{cout} s{s}", count=count,
                         cluster=cb.cluster_for(BATCH, h, h, cout, s),
                         ms=k_ms, device_ms=k_dev, plain_ms=p_ms,
                         library_ms=l_dev, library_event_ms=l_ms,
                         bytes_ms=t_bytes, ops_ms=t_ops,
                         bound_ms=max(t_bytes, t_ops),
                         bound_by="bytes" if t_bytes >= t_ops
                         else "operations"))
    return rows


def tiny_run_agreement(torch, fedml):
    """The whole slice on the card (kernel forward, f32) against the same
    run on the CPU (plain forward), from the same seeded init: one round,
    two clients, bound rtol 1e-3, atol 1e-4. Kept short and
    at a small learning rate on purpose: cuDNN's backward on the card is not
    bitwise reproducible, and at lr 0.05 over 2 rounds two runs of the plain
    version on the card already drift apart by about the bound."""
    cfg = dict(dataset="synthetic_cifar10", model="resnet20",
               client_num_in_total=4, client_num_per_round=2, comm_round=1,
               batch_size=8, learning_rate=0.01, max_total_samples=64,
               synthetic_test_size=64, frequency_of_the_test=1,
               random_seed=3, fused_conv_block="pallas")
    gpu = fedml.run_simulation(**cfg)
    cpu = fedml.run_simulation(device="cpu", **cfg)
    worst = 0.0
    for k, v in cpu["params"].items():
        g = gpu["params"][k].cpu()
        worst = max(worst, ((g - v).abs() / (1e-4 + 1e-3 * v.abs()))
                    .max().item())
    require(worst <= 1.0, f"tiny run: card vs CPU params off by {worst:.2f}"
                          f"x the tolerance")
    require(abs(gpu["final_test_acc"] - cpu["final_test_acc"]) <= 1 / 64,
            "tiny run: test accuracy differs by more than one sample")
    return worst, gpu["final_test_acc"], cpu["final_test_acc"]


def captured_vs_eager(torch):
    """The GPU engine's captured local step against the eager loop on the
    card: four ResNet-20 clients (fused conv block, SGD with momentum 0.9,
    lr 0.01, batch 32) each trained from the same params by one step
    program (captured once, replayed) and by ``run_local_sgd``, in float32
    with TF32 off and in bf16, cuDNN on deterministic algorithms (the f32
    weight-gradient algorithm it picks otherwise is not run-to-run
    reproducible: without this the f32 legs differed by a fraction of the
    bound, the bf16 legs not at all). Returns {dtype: (worst error over
    CAPTURE_TOL, replays)}."""
    out = {}
    torch.backends.cudnn.deterministic = True
    try:
        for precision, tol in CAPTURE_TOL.items():
            out[precision] = _captured_vs_eager(torch, precision, tol)
    finally:
        torch.backends.cudnn.deterministic = False
    return out


def _captured_vs_eager(torch, precision, tol):
    from fedml_tpu_torch import data, model, prng
    from fedml_tpu_torch.arguments import Arguments
    from fedml_tpu_torch.core.algframe.client_trainer import (
        ClassificationTrainer, make_inner_optimizer)
    from fedml_tpu_torch.core.algframe.local_training import (
        StepProgram, batch_real_of, run_local_sgd)
    from fedml_tpu_torch.core.algframe.types import TrainHyper

    args = Arguments(dataset="synthetic_cifar10", model="resnet20",
                     precision=precision, fused_conv_block="pallas",
                     client_num_in_total=4, batch_size=32,
                     max_total_samples=512, random_seed=3)
    fed, n_classes = data.load(args)
    bundle = model.create(args, n_classes, fed.input_shape)
    params = bundle.init(torch.Generator().manual_seed(3), "cuda")
    spec = ClassificationTrainer(bundle.apply)
    opt = make_inner_optimizer("sgd", 0.01, momentum=0.9)
    hyper = TrainHyper(learning_rate=0.01)
    train = fed.train.to(torch.device("cuda"))
    program = StepProgram(spec, opt, params, train.client(0))
    worst = 0.0
    for cid in range(4):
        cdata, key = train.client(cid), prng.fold_in(prng.PRNGKey(3), cid)
        real = batch_real_of(fed.train.mask[cid])
        pg, steps, mg = program.run(params, cdata, key, hyper, real)
        pe, _, me = run_local_sgd(spec, opt, params, cdata, key, hyper,
                                  batch_real=real)
        moved = max((pe[k] - params[k]).abs().max().item() for k in pe)
        diff = max((pg[k] - pe[k]).abs().max().item() for k in pe)
        loss = abs(mg["loss_sum"].item() - me["loss_sum"].item()) / max(
            abs(me["loss_sum"].item()), 1e-6)
        require(steps > 0 and moved > 0,
                f"captured step: client {cid} did not train")
        worst = max(worst, diff / moved / tol, loss / tol)
    require(worst <= 1.0, f"captured step vs eager loop ({precision}): off "
                          f"by {worst:.2f}x the tolerance")
    require(program.captures == 1, f"captured step: {program.captures} "
                                   f"captures for four clients")
    return worst, program.replays


def resume_parity(torch, tmp, dev="cuda"):
    """Phase 5: RESUME's run of 4 rounds against 2 rounds resumed to 4
    from the round-1 checkpoint, on the card, cuDNN on deterministic
    algorithms (as captured_vs_eager): the params must agree bitwise. The
    resumed simulator captures its step (``capture_step``) before ``run``
    restores, so the graph's static tensors take the restored params.
    Returns (largest difference, blocks of the uninterrupted run)."""
    from fedml_tpu_torch import data, model
    from fedml_tpu_torch.arguments import Arguments
    from fedml_tpu_torch.core.algframe.types import TrainHyper
    from fedml_tpu_torch.runner import FedMLRunner

    def simulator(name, **kw):
        args = Arguments(**dict(RESUME, checkpoint_dir=os.path.join(
            tmp, name), **kw))
        fed, n_classes = data.load(args)
        bundle = model.create(args, n_classes, fed.input_shape)
        return FedMLRunner(args, device=dev, dataset=fed,
                           model=bundle).runner

    torch.backends.cudnn.deterministic = True
    try:
        full = simulator("full").run()
        simulator("part", comm_round=2).run()
        sim = simulator("part")
        sim.capture_step(TrainHyper(learning_rate=RESUME["learning_rate"]))
        resumed = sim.run()
    finally:
        torch.backends.cudnn.deterministic = False
    worst = max((full["params"][k] - resumed["params"][k]).abs().max().item()
                for k in full["params"])
    blocks = full["dispatch_stats"]["dispatches"]
    require(blocks == 2, f"resume: {blocks} blocks for 4 rounds with a "
                         f"checkpoint every 2 (want 2: the checkpoint cuts "
                         f"the 8-round block)")
    require([h["round"] for h in resumed["history"]] == [2, 3],
            f"resume: resumed rounds {[h['round'] for h in resumed['history']]}")
    require(resumed["dispatch_stats"]["captures"] == 1,
            "resume: the resumed run did not capture its step once")
    require(worst == 0.0, f"resume: resumed params differ from the "
                          f"uninterrupted run's by up to {worst:.3e}")
    return worst, blocks


def flagship(torch, cb, fa, card, tmp):
    """Phase 6: ``bench_flagship`` on the port. The GPU engine's step is
    captured (timed apart), then one block of FLAGSHIP_BLOCK rounds runs
    through ``run_rounds_fused`` and one eval follows; then the SP golden
    loop runs one round of SP_BASELINE. Returns the ``flagship`` record and
    the kernels' launches over the engine's leg."""
    from fedml_tpu_torch import data, model
    from fedml_tpu_torch.arguments import Arguments
    from fedml_tpu_torch.core.algframe.local_training import step_count
    from fedml_tpu_torch.core.algframe.types import TrainHyper
    from fedml_tpu_torch.core.obs import profiler
    from fedml_tpu_torch.runner import FedMLRunner

    def simulator(cfg):
        args = Arguments(**cfg)
        fed, n_classes = data.load(args)
        bundle = model.create(args, n_classes, fed.input_shape)
        return (FedMLRunner(args, dataset=fed, model=bundle).runner, fed,
                n_classes)

    sim, fed, n_classes = simulator(MAIN_PATH)
    hyper = TrainHyper(learning_rate=MAIN_PATH["learning_rate"], epochs=1)
    reset_launches(cb, fa)
    capture_s = sim.capture_step(hyper)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    block = sim.run_rounds_fused(0, FLAGSHIP_BLOCK, hyper)
    torch.cuda.synchronize()
    block_s = time.perf_counter() - t0
    state = card_state()
    round_s = block_s / FLAGSHIP_BLOCK
    ev = sim.evaluate()
    torch.cuda.synchronize()
    engine_launches = launches(cb, fa)
    for r, m in enumerate(block):
        print(f"flagship round {r}: {m['local_steps']} local steps, "
              f"train_loss {m['loss_sum'] / m['count']:.4f}", flush=True)
        require(all(math.isfinite(m[k]) for k in ("loss_sum", "correct")),
                f"flagship round {r}: non-finite metrics")
    require(math.isfinite(ev["test_loss"]), "flagship: non-finite eval")
    require(all(torch.isfinite(v).all().item()
                for v in sim.params.values()), "flagship: non-finite params")
    require(sim.dispatch_stats["captures"] == 1 and len(sim.programs) == 1,
            f"flagship: {sim.dispatch_stats['captures']} captures, "
            f"{len(sim.programs)} step programs (want 1 and 1)")
    (program,) = sim.programs.values()
    nodes = sum(B1_KERNEL_NAME[MAIN_PATH["precision"]] in line
                for line in graph_dot(program.graph).splitlines())
    steps = sum(m["local_steps"] for m in block)
    n_eval = int(sim.test["x"].shape[0])
    forwards = program.warmup_steps + program.replays + n_eval
    n_b1 = engine_launches["conv_block"]
    require(nodes == program.graph_launches.get(cb.fused_block) == 27,
            f"flagship: the captured step holds {nodes} B1 nodes (DOT dump)"
            f" and {program.graph_launches.get(cb.fused_block)} counted "
            f"at capture, expected 27")
    require(program.replays == steps, f"flagship: {program.replays} "
                                      f"replays for {steps} local steps")
    require(n_b1 == 27 * forwards,
            f"flagship: B1 launched {n_b1} times, expected 27 x {forwards} "
            f"forward passes ({program.warmup_steps} warm-up, "
            f"{program.replays} replayed, {n_eval} eval)")
    handoff = flagship_handoff(torch, cb, fa, sim, MAIN_PATH, n_classes,
                               fed.input_shape, tmp)
    flops = sim.round_cost_flops(hyper)
    tflops = flops / round_s / 1e12
    mfu = profiler.mfu_value(flops, round_s, 1, device="cuda")
    if "H100" in torch.cuda.get_device_name(0):
        require(mfu is not None, "flagship: MFU is null on an H100")

    sp, sp_fed, _ = simulator(SP_BASELINE)
    reset_launches(cb, fa)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sp.run(1)
    torch.cuda.synchronize()
    sp_round_s = time.perf_counter() - t0
    sp_steps = sum(step_count(sp.batch_real[c], hyper)
                   for c in range(sp_fed.num_clients))
    require(launches(cb, fa)["conv_block"] == 27 * sp_steps,
            f"SP baseline: B1 launched {launches(cb, fa)['conv_block']} "
            f"times, expected 27 x {sp_steps}")
    samples = float(fed.client_num_samples.sum())
    sp_samples = float(sp_fed.client_num_samples.sum())
    name, limit = (w.strip() for w in card.split(","))
    record = {
        "metric": "fedavg_resnet56_cifar10_rounds_per_hour",
        "value": 3600.0 / round_s,
        "unit": f"rounds/hour (64 clients/round, 1 local epoch, bf16, "
                f"{fed.provenance} data)",
        # the captured-step engine against the eager golden loop, both on
        # this one card (per-sample normalised): not the TPU bench's
        # meaning (a mesh against per-client dispatches)
        "vs_baseline": (sp_round_s / sp_samples) / (round_s / samples),
        "sp_baseline_round_s": sp_round_s,
        "sp_baseline_samples": int(sp_samples),
        "step_time_s": round_s,
        "block_s": block_s, "block_rounds": FLAGSHIP_BLOCK,
        "local_steps": steps, "sp_local_steps": sp_steps,
        "ms_per_local_step": block_s / steps * 1e3,
        "round_flops": flops, "tflops": tflops, "mfu": mfu,
        "peak_tflops": profiler.peak_tflops("cuda"),
        "n_devices": 1, "data_provenance": fed.provenance,
        "captures": sim.dispatch_stats["captures"],
        "capture_s": capture_s, "warmup_steps": program.warmup_steps,
        "b1_graph_nodes": nodes, "b1_launches": n_b1,
        "b1_per_forward": n_b1 / forwards,
        "test_acc_after_block": ev["test_acc"],
        "hbm_peak_gb": profiler.sample_hbm_peak_gb("cuda"),
        "handoff": handoff, "card": name, "power_limit": limit,
        "card_after_block": state}
    return record, engine_launches


def flagship_handoff(torch, cb, fa, sim, cfg, n_classes, input_shape,
                     tmp):
    """Phase 6 after the timed block: the engine's checkpoint state
    through ``RoundCheckpointer`` (file bytes, seconds of ``maybe_save``,
    the synchronous host snapshot, and of ``flush``; restored bitwise),
    then the model artifact: ``save_model`` of the params and
    ``CheckpointPredictor.from_files`` on the card, one batch of 32 test
    images bitwise equal to the engine's own eval forward (the same
    bundle settings: bf16, the fused B1), 27 B1 launches."""
    from fedml_tpu_torch.arguments import Arguments
    from fedml_tpu_torch.core.checkpoint import RoundCheckpointer
    from fedml_tpu_torch.serving import CheckpointPredictor, save_model

    ck = RoundCheckpointer(os.path.join(tmp, "flagship_ckpt"), 1)
    r = FLAGSHIP_BLOCK - 1
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ck.maybe_save(r, sim.ckpt_state())
    save_s = time.perf_counter() - t0
    ck.flush()
    flush_s = time.perf_counter() - t0 - save_s
    ckpt_bytes = os.path.getsize(ck.file(r))
    step, st = ck.latest(sim.ckpt_state())
    require(step == r and all(torch.equal(st["params"][k], v)
                              for k, v in sim.params.items()),
            "flagship checkpoint: the restored params differ")

    t0 = time.perf_counter()
    path = save_model(sim.params, os.path.join(tmp, "resnet56.fmtpu"))
    artifact_s = time.perf_counter() - t0
    pred = CheckpointPredictor.from_files(Arguments(**cfg), path,
                                          n_classes, input_shape,
                                          device=sim.device)
    x = sim.test["x"][0][:BATCH]
    with torch.no_grad():
        want = sim.bundle.apply(sim.params, x).cpu()
    reset_launches(cb, fa)
    got = torch.tensor(pred.predict({"inputs": x.cpu().tolist()})[
        "outputs"], dtype=torch.float32)
    n_b1 = launches(cb, fa)["conv_block"]
    err = (got - want).abs().max().item()
    require(tuple(got.shape) == (x.shape[0], n_classes)
            and torch.isfinite(got).all().item(),
            f"CheckpointPredictor: logits of shape {tuple(got.shape)}")
    require(err == 0.0, f"CheckpointPredictor: logits off the engine's "
                        f"eval forward by {err:.3e} (same dtype and kernels:"
                        f" bitwise expected)")
    require(n_b1 == 27, f"CheckpointPredictor: {n_b1} B1 launches for one "
                        f"forward, expected 27")
    return {"checkpoint_bytes": ckpt_bytes, "maybe_save_s": save_s,
            "flush_s": flush_s, "artifact_bytes": os.path.getsize(path),
            "save_model_s": artifact_s, "predict_images": int(x.shape[0]),
            "predict_max_abs_err": err, "predict_b1_launches": n_b1}


def family_agreement(torch, fedml):
    """Phase 7 (a): every FAMILY configuration through the GPU engine
    (its programs captured) and the SP loop (eager) on the card, cuDNN on
    deterministic algorithms. Returns {label: (largest param difference,
    largest update, captures)}."""
    out = {}
    torch.backends.cudnn.deterministic = True
    try:
        for label, kw in FAMILY.items():
            cfg = dict(FAMILY_CFG, federated_optimizer=label.split("_")[0],
                       **kw)
            gpu = fedml.run_simulation(**cfg)
            sp = fedml.run_simulation(backend="sp", **cfg)
            p0 = fedml.run_simulation(backend="sp",
                                      **dict(cfg, comm_round=0))["params"]
            moved = max((sp["params"][k] - p0[k]).abs().max().item()
                        for k in p0)
            diff = max((gpu["params"][k] - sp["params"][k]).abs().max()
                       .item() for k in p0)
            captures = gpu["dispatch_stats"]["captures"]
            want = 2 if label == "Mime" else 1
            require(moved > 0 and all(torch.isfinite(v).all().item()
                                      for v in gpu["params"].values()),
                    f"family {label}: the run did not train or diverged")
            require(captures == want, f"family {label}: {captures} "
                                      f"captures, expected {want}")
            require(diff <= FAMILY_ULPS * 2.0 ** -23 * moved,
                    f"family {label}: GPU engine vs SP loop differ by "
                    f"{diff:.3e}, more than {FAMILY_ULPS} ulps of the "
                    f"largest update {moved:.3e}")
            out[label] = (diff, moved, captures)
    finally:
        torch.backends.cudnn.deterministic = False
    return out


def _simulator(cfg):
    from fedml_tpu_torch import data, model
    from fedml_tpu_torch.arguments import Arguments
    from fedml_tpu_torch.runner import FedMLRunner
    args = Arguments(**cfg)
    fed, n_classes = data.load(args)
    bundle = model.create(args, n_classes, fed.input_shape)
    return FedMLRunner(args, dataset=fed, model=bundle).runner


def scaffold_flagship(torch, cb, fa):
    """Phase 7 (b): SCAFFOLD on the flagship's configuration. Its step
    (the control-variate transform inside) is captured apart, then one
    block of FLAGSHIP_BLOCK rounds is timed and one eval follows. Returns
    its record and the kernels' launches over the path."""
    from fedml_tpu_torch.core.algframe.types import TrainHyper
    sim = _simulator(SCAFFOLD_PATH)
    hyper = TrainHyper(learning_rate=SCAFFOLD_PATH["learning_rate"])
    reset_launches(cb, fa)
    capture_s = sim.capture_step(hyper)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    block = sim.run_rounds_fused(0, FLAGSHIP_BLOCK, hyper)
    torch.cuda.synchronize()
    block_s = time.perf_counter() - t0
    state = card_state()
    ev = sim.evaluate()
    torch.cuda.synchronize()
    path_launches = launches(cb, fa)
    (program,) = sim.programs.values()
    steps = sum(m["local_steps"] for m in block)
    n_eval = int(sim.test["x"].shape[0])
    forwards = program.warmup_steps + program.replays + n_eval
    n_b1 = path_launches["conv_block"]
    require(all(math.isfinite(m["loss_sum"]) for m in block)
            and math.isfinite(ev["test_loss"]),
            "SCAFFOLD flagship: non-finite metrics")
    require(sim.dispatch_stats["captures"] == 1,
            f"SCAFFOLD flagship: {sim.dispatch_stats['captures']} captures")
    require(program.grad_transform is not None,
            "SCAFFOLD flagship: the captured step has no transform")
    require(program.replays == steps, f"SCAFFOLD flagship: "
                                      f"{program.replays} replays for "
                                      f"{steps} local steps")
    require(program.graph_launches.get(cb.fused_block) == 27
            and n_b1 == 27 * forwards,
            f"SCAFFOLD flagship: B1 launched {n_b1} times, expected 27 x "
            f"{forwards} forward passes")
    c_i = sim.client_states["c_i"]
    state_bytes = sum(v.numel() * v.element_size() for v in c_i.values())
    # every client trained (64 of 64 a round), so every row moved
    rows = int((torch.stack([v.flatten(1).abs().amax(1) for v in
                             c_i.values()]).amax(0) > 0).sum().item())
    require(rows == sim.fed.num_clients,
            f"SCAFFOLD flagship: {rows} clients' c_i moved, expected "
            f"{sim.fed.num_clients}")
    round_s = block_s / FLAGSHIP_BLOCK
    return {"rounds_per_hour": 3600.0 / round_s, "step_time_s": round_s,
            "block_s": block_s, "block_rounds": FLAGSHIP_BLOCK,
            "local_steps": steps,
            "ms_per_local_step": block_s / steps * 1e3,
            "capture_s": capture_s, "warmup_steps": program.warmup_steps,
            "replays": program.replays, "eval_batches": n_eval,
            "b1_launches": n_b1, "b1_per_forward": n_b1 / forwards,
            "client_state_rows": rows,
            "client_state_bytes": state_bytes, "card_after_block": state,
            "test_acc_after_block": ev["test_acc"]}, path_launches


def fedsgd_fold(torch, cb, fa, gen):
    """Phase 7 (c): B1 against its plain version at the folded batch (the
    five ResNet-56 geometries at FOLD_BATCH, bf16), then one FedSGD round
    of FEDSGD_PATH with client_slot_fold on and one with it off, each
    with its gradient program captured apart. Returns the record and the
    kernels' launches over each round."""
    from fedml_tpu_torch.core.algframe.types import TrainHyper
    dtype = FEDSGD_PATH["precision"]
    errs = []
    for (h, cin, cout, s), _ in FLAGSHIP:
        err, gerr, _ = check_case(torch, cb, gen,
                                  (FOLD_BATCH, h, h, cin, cout, s), dtype,
                                  flips=True)
        errs.append(err)
        print(f"check {dtype} n,h,w,cin,cout,s={(FOLD_BATCH, h, h, cin, cout, s)}"
              f" (the fold's batch): max abs err {err:.3e}, grad rel err "
              f"{gerr:.3e}", flush=True)
    hyper = TrainHyper(learning_rate=FEDSGD_PATH["learning_rate"])
    rounds = {}
    for fold in (True, False):
        sim = _simulator(dict(FEDSGD_PATH, client_slot_fold=fold))
        p0 = {k: v.clone() for k, v in sim.params.items()}
        reset_launches(cb, fa)
        capture_s = sim.capture_step(hyper)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = sim.run_round(0, hyper)
        torch.cuda.synchronize()
        round_s = time.perf_counter() - t0
        n = launches(cb, fa)
        (program,) = sim.programs.values()
        passes = program.warmup_steps + program.replays
        require(n["conv_block"] == 27 * passes,
                f"FedSGD (fold {fold}): B1 launched {n['conv_block']} "
                f"times, expected 27 x {passes} passes")
        require(math.isfinite(m["loss_sum"]), f"FedSGD (fold {fold}): "
                                              f"non-finite loss")
        rounds[fold] = dict(
            round_s=round_s, capture_s=capture_s, passes=program.replays,
            batch=int(program.batch["x"].shape[0]),
            b1_launches=n["conv_block"], count=m["count"],
            train_loss=m["loss_sum"] / m["count"],
            agg={k: (sim.params[k] - p0[k]).float() for k in p0},
            launches=n)
        del sim
    fold, unfold = rounds[True], rounds[False]
    require(fold["batch"] == FOLD_BATCH and fold["count"] == unfold["count"],
            f"FedSGD fold: batch {fold['batch']}, {fold['count']} vs "
            f"{unfold['count']} samples")
    diff = max((fold["agg"][k] - unfold["agg"][k]).abs().max().item()
               for k in unfold["agg"])
    largest = max(v.abs().max().item() for v in unfold["agg"].values())
    require(largest > 0 and diff <= FOLD_TOL * largest,
            f"FedSGD fold: folded aggregate off the unfolded one by "
            f"{diff:.3e} ({diff / max(largest, 1e-30):.2e} of its largest "
            f"entry, bound {FOLD_TOL:.2e})")
    for r in rounds.values():
        del r["agg"]
    return {"b1_fold_batch_max_abs_err": max(errs), "fold": fold,
            "unfold": unfold, "max_abs_diff": diff, "largest": largest,
            "rel_diff": diff / largest}


def robust_simulator(cfg, dev=None, fed=None):
    """A simulator of ``cfg`` (the GPU engine or the SP loop) on ``dev``
    (the card unless given), on ``fed`` when given (the dataset ``cfg``
    loads, loaded once for several legs)."""
    from fedml_tpu_torch import data, model
    from fedml_tpu_torch.arguments import Arguments
    from fedml_tpu_torch.runner import FedMLRunner
    args = Arguments(**cfg)
    if fed is None:
        fed, _ = data.load(args)
    bundle = model.create(args, fed.num_classes, fed.input_shape)
    return FedMLRunner(args, device=dev, dataset=fed, model=bundle).runner


def _largest(torch, a, b):
    return max((a[k].float() - b[k].float()).abs().max().item() for k in b)


def robust_agreement(torch, cfgs=None, dev=None):
    """Phase 8 (a): every ROBUST configuration on FAMILY_CFG through the
    GPU engine's fused path, its host path (robust configurations) and
    the SP loop, cuDNN on deterministic algorithms. Returns {label:
    record}."""
    import numpy as np
    out = {}
    torch.backends.cudnn.deterministic = True
    try:
        for label, kw in (cfgs or ROBUST).items():
            cfg = dict(FAMILY_CFG, **kw)
            fused = robust_simulator(cfg, dev)
            p0 = {k: v.clone() for k, v in fused.params.items()}
            fused.run()
            sp = robust_simulator(dict(cfg, backend="sp"), dev)
            sp.run()
            moved = _largest(torch, fused.params, p0)
            rec = {"robust_mode": fused.robust_mode,
                   "fused": fused.robust_fused, "largest_update": moved,
                   "captures": fused.dispatch_stats["captures"]}
            require(moved > 0 and all(torch.isfinite(v).all().item()
                                      for v in fused.params.values()),
                    f"robust {label}: the run did not train or diverged")
            require(rec["captures"] == (0 if dev == "cpu" else 1),
                    f"robust {label}: {rec['captures']} captures")
            if fused.robust_mode:
                host = robust_simulator(dict(cfg, robust_fused="host"), dev)
                host.run()
                rec["fused_vs_host"] = _largest(torch, fused.params,
                                                host.params)
                rec["verdict_diff"] = max(
                    float(np.abs(fused.verdicts[r][1]
                                 - host.verdicts[r][1]).max())
                    for r in fused.verdicts)
                require(fused.robust_fused and not host.robust_fused
                        and sorted(fused.verdicts) == sorted(host.verdicts)
                        == [0, 1], f"robust {label}: paths or verdicts "
                                   f"missing")
                require(rec["fused_vs_host"]
                        <= ROBUST_ULPS * 2.0 ** -23 * moved
                        and rec["verdict_diff"] == 0.0,
                        f"robust {label}: fused vs host differ by "
                        f"{rec['fused_vs_host']:.3e} (verdicts by "
                        f"{rec['verdict_diff']:.3e}), bound {ROBUST_ULPS} "
                        f"ulps of {moved:.3e}")
            if label not in ROBUST_STOCHASTIC:
                rec["engine_vs_sp"] = _largest(torch, fused.params,
                                               sp.params)
                bound = (ROBUST_SP_TOL if fused.robust_mode
                         else ROBUST_ULPS * 2.0 ** -23)
                require(rec["engine_vs_sp"] <= bound * moved,
                        f"robust {label}: engine vs SP loop differ by "
                        f"{rec['engine_vs_sp']:.3e}, bound {bound:.1e} of "
                        f"{moved:.3e}")
            out[label] = rec
    finally:
        torch.backends.cudnn.deterministic = False
    return out


def device_normal_check(torch, dev="cuda", n=FLAGSHIP_PARAMS):
    """The torch form of ``prng.normal`` on the card against its numpy
    form on the host, ``n`` draws: the largest difference in float32
    ulps (bound 1) and the device milliseconds of one draw."""
    import numpy as np

    from fedml_tpu_torch import prng
    key = prng.fold_in(prng.PRNGKey(7), 999983)
    host = prng.normal(key, n)
    got = prng.normal_t(key, n, dev)
    ms = time_ms(torch, lambda: prng.normal_t(key, n, dev), iters=10,
                 warmup=2) if dev == "cuda" else None
    a = got.cpu().numpy().view(np.int32).astype(np.int64)
    b = host.view(np.int32).astype(np.int64)
    ulps = int(np.abs(a - b).max())
    require(ulps <= 1 and np.isfinite(host).all(),
            f"device normal: {ulps} ulps off the host form at {n} draws")
    return {"draws": n, "max_ulps": ulps, "device_ms": ms}


class _DeviceTimer:
    """Wraps a simulator's bound method: CUDA events around every call
    (on the CPU, nothing), summed after the block."""

    def __init__(self, torch, sim, name):
        self.torch, self.events = torch, []
        inner = getattr(sim, name)
        cuda = sim.device.type == "cuda"

        def timed(*a, **kw):
            if not cuda:
                return inner(*a, **kw)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = inner(*a, **kw)
            end.record()
            self.events.append((start, end))
            return out

        setattr(sim, name, timed)

    def ms(self):
        if self.events:
            self.torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in self.events)


def robust_flagship(torch, cb, fa, legs=ROBUST_LEGS, dev=None):
    """Phase 8 (b): the defended flagship legs. Each leg's step is
    captured apart, then its rounds run through ``run_rounds_fused``; the
    device milliseconds of the attack + defense + CDP (and, on the LDP
    leg, of each client's clip and noise) come from CUDA events around
    them. Returns {leg: record} and the kernels' launches over the fused
    leg."""
    from fedml_tpu_torch import data
    from fedml_tpu_torch.arguments import Arguments
    from fedml_tpu_torch.core.algframe.types import TrainHyper
    out, fused_launches = {}, None
    # the legs differ in trust knobs only: one dataset for all of them
    fed, _ = data.load(Arguments(**legs[0][1]))
    for leg, cfg, n_rounds in legs:
        sim = robust_simulator(cfg, dev, fed)
        server = _DeviceTimer(torch, sim, "_server_aggregate")
        client = _DeviceTimer(torch, sim, "_client_dp")
        hyper = TrainHyper(learning_rate=cfg["learning_rate"], epochs=1)
        reset_launches(cb, fa)
        capture_s = sim.capture_step(hyper)
        if sim.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        block = sim.run_rounds_fused(0, n_rounds, hyper)
        if sim.device.type == "cuda":
            torch.cuda.synchronize()
        block_s = time.perf_counter() - t0
        n = launches(cb, fa)
        (program,) = sim.programs.values()
        forwards = program.warmup_steps + program.replays
        require(all(math.isfinite(m["loss_sum"]) for m in block)
                and all(torch.isfinite(v).all().item()
                        for v in sim.params.values()),
                f"defended flagship {leg}: non-finite metrics or params")
        if sim.device.type == "cuda":
            require(sim.dispatch_stats["captures"] == 1
                    and program.graph_launches.get(cb.fused_block) == 27
                    and n["conv_block"] == 27 * forwards,
                    f"defended flagship {leg}: "
                    f"{sim.dispatch_stats['captures']} captures, B1 "
                    f"launched {n['conv_block']} times for {forwards} "
                    f"forward passes (27 each expected)")
        byz = int(cfg.get("byzantine_client_num", 0) or 0)
        kept = []
        for r in range(n_rounds):
            if not sim.robust_mode:
                break
            sampled, v = sim.verdicts[r]
            flipped = [k for k, c in enumerate(sampled) if c < byz]
            kept.append(int((v > 0).sum()))
            require(len(flipped) == byz and not (v[flipped] > 0).any()
                    and kept[-1] == cfg["krum_param_m"],
                    f"defended flagship {leg} round {r}: the verdict keeps "
                    f"{kept[-1]} clients, flipped ones among them: "
                    f"{[sampled[k] for k in flipped if v[k] > 0]}")
        round_s = block_s / n_rounds
        mat = sim._mat
        out[leg] = {
            "rounds": n_rounds, "block_s": block_s, "step_time_s": round_s,
            "rounds_per_hour": 3600.0 / round_s, "capture_s": capture_s,
            "defense_ms_per_round": (server.ms() + client.ms()) / n_rounds
            if sim.device.type == "cuda" else None,
            "server_ms_per_round": server.ms() / n_rounds
            if sim.device.type == "cuda" else None,
            "client_dp_ms_per_round": client.ms() / n_rounds
            if sim.device.type == "cuda" else None,
            "matrix_bytes": None if mat is None
            else mat.numel() * mat.element_size(),
            "verdict_kept": kept, "b1_launches": n["conv_block"],
            "b1_per_forward": n["conv_block"] / max(forwards, 1),
            "captures": sim.dispatch_stats["captures"],
            "hbm_peak_gb": torch.cuda.max_memory_allocated() / 1e9
            if sim.device.type == "cuda" else None,
            "dp_epsilon_spent": sim.dp.get_epsilon_spent()
            if sim.dp.is_dp_enabled() else None}
        if leg == "fused":
            fused_launches = n
        del sim, program, mat
        if dev != "cpu":
            torch.cuda.empty_cache()
    return out, fused_launches


def _house_ratio(torch, card, cpu, extra_atol=0.0):
    """The largest |card - cpu| over ``atol + extra_atol + rtol |cpu|``
    (HOUSE_TOL) across the params: at most 1 passes."""
    rtol, atol = HOUSE_TOL
    worst = 0.0
    for k, v in cpu.items():
        v = v.detach().float().cpu()
        g = card[k].detach().float().cpu()
        worst = max(worst, ((g - v).abs()
                            / (atol + extra_atol + rtol * v.abs()))
                    .max().item())
    return worst


def _cohorts(run):
    """Run ``run()`` with the obs sink catching the selection records;
    returns its result and the cohort of every round."""
    from fedml_tpu_torch.core.obs import sink
    got = []
    sink.set_sink(got.append)
    try:
        out = run()
    finally:
        sink.set_sink(None)
    return out, [r["sampled"] for r in got if r["kind"] == "selection"]


def _defense_inputs(run):
    """Run ``run()`` and return, per round, the ``[K, D]`` rows the GPU
    engine handed ``quantize_rows`` and the matrix its defense then saw,
    both copied to the CPU."""
    import fedml_tpu_torch.simulation.gpu.engine as eng
    sharded = eng.sharded_defense
    quant, defend = eng.quantize_rows, sharded.defend_shard_stateful
    rec = []

    def record_quant(mat, mode):
        rec.append([mat.detach().cpu().clone()])
        return quant(mat, mode)

    def record_defend(mat, *a, **kw):
        rec[-1].append(mat.detach().cpu().clone())
        return defend(mat, *a, **kw)

    eng.quantize_rows, sharded.defend_shard_stateful = (record_quant,
                                                        record_defend)
    try:
        run()
    finally:
        eng.quantize_rows, sharded.defend_shard_stateful = quant, defend
    return rec


def _relayout_matrix_check(torch, mode, rec_card, rec_cpu):
    """The relayout's rounding on the card, held at the defense's input.
    Every round: the card's defense input is ``quantize_rows`` of its own
    rows on the CPU, bitwise (the CPU rounding is the JAX formula's,
    bitwise, in the tests). Round 0 (same start parameters), card vs CPU:
    at most RELAYOUT_FLIP_SHARE of the entries on another level, int8
    codes at most one level apart and the per-row scales within the house
    rtol; bf16 entries within one level (``rtol=2**-7``) or, where the
    raw rows' card-vs-CPU gap spans several levels of a tiny entry,
    within the house atol."""
    from fedml_tpu_torch.simulation.gpu.engine import quantize_rows
    require(len(rec_card) == len(rec_cpu) == FAMILY_CFG["comm_round"]
            and all(len(r) == 2 for r in rec_card + rec_cpu),
            f"relayout {mode}: {len(rec_card)} / {len(rec_cpu)} rounds "
            f"recorded")
    for raw, seen in rec_card:
        require(torch.equal(seen, quantize_rows(raw, mode))
                and not torch.equal(seen, raw),
                f"relayout {mode}: the card's defense input is not the "
                f"rounding of its rows")
    a, b = rec_card[0][1], rec_cpu[0][1]
    rtol, atol = HOUSE_TOL
    if mode == "int8":
        sa = a.abs().amax(dim=1, keepdim=True) / 127.0
        sb = b.abs().amax(dim=1, keepdim=True) / 127.0
        la = torch.round(a / torch.where(sa > 0, sa, 1.0 / 127.0))
        lb = torch.round(b / torch.where(sb > 0, sb, 1.0 / 127.0))
        flips = int((la != lb).sum())
        within = (bool((la - lb).abs().max() <= 1)
                  and bool(((sa - sb).abs() <= rtol * sb.abs()).all()))
    else:
        la = a.view(torch.int32) >> 16
        lb = b.view(torch.int32) >> 16
        flips = int((la != lb).sum())
        within = bool(((a - b).abs() <= torch.maximum(
            2.0 ** -7 * b.abs(), torch.full_like(b, atol))).all())
    share = flips / a.numel()
    require(within and share <= RELAYOUT_FLIP_SHARE,
            f"relayout {mode}: round 0's defense input, card vs CPU: "
            f"{flips} of {a.numel()} entries on another level "
            f"({share:.2e}), within one level: {within}")
    return {"round0_flips": flips, "round0_entries": a.numel()}


def faults_agreement(torch, dev=None, cpu="cpu"):
    """Phase 9 (a): chaos, selection, contribution, the user aggregator,
    the relayout quantization and crash-resume on ResNet-20 runs (cuDNN
    on deterministic algorithms). ``dev`` None is the card; ``cpu`` the
    reference device. Returns {check: record}."""
    import tempfile

    import numpy as np
    from fedml_tpu_torch.core.algframe.server_aggregator import \
        ServerAggregator
    from fedml_tpu_torch.core.chaos import ChaosCrash
    from fedml_tpu_torch.core.checkpoint import RoundCheckpointer
    from fedml_tpu_torch.core.security.defense import robust_agg

    class Median(ServerAggregator):
        calls = 0

        def aggregate(self, update_matrix, weights):
            Median.calls += 1
            return robust_agg.coordinate_median(update_matrix, weights)[0]

    out = {}
    torch.backends.cudnn.deterministic = True
    try:
        chaos_cfg = dict(FAMILY_CFG, **FAULTS_CHAOS)
        for tol in (True, False):
            cfg = dict(chaos_cfg, chaos_tolerance=tol)
            card = robust_simulator(cfg, dev)
            card.run()
            ref = robust_simulator(cfg, cpu)
            ref.run()
            ratio = _house_ratio(torch, card.params, ref.params)
            ledger = card.chaos_ledger.rounds()
            require(ledger == ref.chaos_ledger.rounds() and len(ledger) == 2,
                    f"chaos tolerance={tol}: the ledgers differ: {ledger} vs "
                    f"{ref.chaos_ledger.rounds()}")
            require(ratio <= 1.0, f"chaos tolerance={tol}: card vs CPU "
                                  f"{ratio:.2f}x the house tolerance")
            out[f"chaos_tolerance_{'on' if tol else 'off'}"] = {
                "house_ratio": ratio,
                "dropped": sum(len(r["injected"]["dropped"])
                               for r in ledger),
                "stragglers": sum(len(r["injected"]["stragglers"])
                                  for r in ledger)}
        plain = robust_simulator(FAMILY_CFG, dev)
        plain.run()
        zero = robust_simulator(dict(FAMILY_CFG, chaos_dropout_prob=0.0,
                                     chaos_straggler_prob=0.0, chaos_seed=5,
                                     chaos_crash_at_round=99), dev)
        require(zero.chaos.enabled, "chaos zero: the plan is not built")
        zero.run()
        require(all(torch.equal(plain.params[k], zero.params[k])
                    for k in plain.params),
                "chaos at probability 0 differs from the chaos-free run")
        out["chaos_zero_bitwise"] = True

        for label, kw in FAULTS_SELECTION.items():
            cfg = dict(FAMILY_CFG, **FAULTS_SELECTION_CFG, **kw)
            card = robust_simulator(cfg, dev)
            _, c_card = _cohorts(card.run)
            ref = robust_simulator(cfg, cpu)
            _, c_ref = _cohorts(ref.run)
            if c_card != c_ref:
                margin = float(abs(card.selection.store.losses
                                   - ref.selection.store.losses).max())
                print(f"selection {label}: cohorts differ (card {c_card}, "
                      f"CPU {c_ref}); largest loss difference between the "
                      f"two stores {margin:.3e}", flush=True)
            require(c_card == c_ref and len(c_card) == 3,
                    f"selection {label}: cohorts differ from the CPU run's")
            out[f"selection_{label}"] = {
                "cohorts": c_card,
                "house_ratio": _house_ratio(torch, card.params, ref.params),
                "benched": sorted(int(c) for c in np.flatnonzero(
                    card.selection.store.reputation < 0.3))
                if label == "reputation" else []}

        for method in ("loo", "gtg"):
            cfg = dict(FAMILY_CFG, contribution_method=method)
            fused = robust_simulator(cfg, dev)
            fused.run()
            host = robust_simulator(dict(cfg, robust_fused="host"), dev)
            host.run()
            require(fused.robust_fused and not host.robust_fused
                    and fused.contribution.history
                    == host.contribution.history
                    and fused.contribution.evaluations
                    == host.contribution.evaluations
                    and all(torch.equal(fused.params[k], host.params[k])
                            for k in host.params),
                    f"contribution {method}: fused and host differ")
            out[f"contribution_{method}"] = {
                "values": [h["contributions"]
                           for h in fused.contribution.history],
                "evaluations": fused.contribution.evaluations}

        agg = Median()
        from fedml_tpu_torch import data, model
        from fedml_tpu_torch.arguments import Arguments
        from fedml_tpu_torch.runner import FedMLRunner
        args = Arguments(**FAMILY_CFG)
        fed, _ = data.load(args)
        user = FedMLRunner(args, device=dev, dataset=fed,
                           model=model.create(args, fed.num_classes,
                                              fed.input_shape),
                           server_aggregator=agg).runner
        user.run()
        builtin = robust_simulator(dict(FAMILY_CFG, enable_defense=True,
                                        defense_type="coordinate_median",
                                        sharded_defense=False), dev)
        builtin.run()
        require(Median.calls == FAMILY_CFG["comm_round"]
                and all(torch.equal(user.params[k], builtin.params[k])
                        for k in user.params),
                f"user aggregator: {Median.calls} calls, or it differs from "
                f"the built-in coordinate_median")
        out["user_aggregator_bitwise"] = True

        for mode in ("int8", "bf16"):
            cfg = dict(FAMILY_CFG, enable_defense=True,
                       defense_type="multi_krum", krum_param_m=2,
                       robust_relayout_quant=mode)
            card = robust_simulator(cfg, dev)
            rec_card = _defense_inputs(card.run)
            ref = robust_simulator(cfg, cpu)
            rec_ref = _defense_inputs(ref.run)
            out[f"relayout_{mode}"] = matrix = _relayout_matrix_check(
                torch, mode, rec_card, rec_ref)
            quantum = float(card._mat.abs().max()) * RELAYOUT_QUANTUM[mode]
            ratio = _house_ratio(torch, card.params, ref.params, quantum)
            require(card._relayout_quant == mode and ratio <= 1.0,
                    f"relayout {mode}: card vs CPU {ratio:.2f}x the house "
                    f"tolerance plus one quantum ({quantum:.2e})")
            matrix.update(ratio=ratio, quantum=quantum,
                          house_ratio=_house_ratio(torch, card.params,
                                                   ref.params))

        cfg = dict(FAMILY_CFG, comm_round=3, checkpoint_every_rounds=1,
                   **FAULTS_CHAOS)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_crash_") as d:
            full = robust_simulator(dict(cfg, checkpoint_dir=f"{d}/full"),
                                    dev)
            full.run()
            crash = dict(cfg, checkpoint_dir=f"{d}/crash",
                         chaos_crash_at_round=1)
            try:
                robust_simulator(crash, dev).run()
                crashed = None
            except ChaosCrash as e:
                crashed = e.round_idx
            steps = RoundCheckpointer(f"{d}/crash", 1).steps()
            require(crashed == 1 and steps[-1] == 1,
                    f"crash: raised at {crashed}, checkpoints {steps}")
            resumed = robust_simulator(crash, dev)
            r = resumed.run()
            require([h["round"] for h in r["history"]] == [2]
                    and all(torch.equal(full.params[k], resumed.params[k])
                            for k in full.params),
                    "crash: the resumed run differs from the uninterrupted")
        out["crash_resume_bitwise"] = True
    finally:
        torch.backends.cudnn.deterministic = False
    return out


def faults_flagship(torch, cb, fa, legs=FAULTS_LEGS, dev=None):
    """Phase 9 (b): the round under faults and selection at full width.
    Each leg's step is captured apart, then its rounds run through
    ``run_rounds_fused`` (selection records through the obs sink, the LOO
    assessment timed). Returns {leg: record} and the kernels' launches
    over leg 1."""
    import numpy as np
    from fedml_tpu_torch import data
    from fedml_tpu_torch.arguments import Arguments
    from fedml_tpu_torch.core.algframe.local_training import step_count
    from fedml_tpu_torch.core.algframe.types import TrainHyper
    out, chaos_launches = {}, None
    # the legs differ in round knobs only: one dataset for all of them
    fed, _ = data.load(Arguments(**legs[0][1]))
    for leg, cfg, n_rounds in legs:
        sim = robust_simulator(cfg, dev, fed)
        cuda = sim.device.type == "cuda"
        hyper = TrainHyper(learning_rate=cfg["learning_rate"], epochs=1)
        assess = sim._assess_contribution
        loo_s = []

        def timed(*a, _inner=assess, **kw):
            t0 = time.perf_counter()
            _inner(*a, **kw)
            loo_s.append(time.perf_counter() - t0)

        sim._assess_contribution = timed
        cohorts = []
        schedule = sim._schedule_for

        def noted(r, _inner=schedule):
            sampled, works = _inner(r)
            cohorts.append(list(sampled))
            return sampled, works

        sim._schedule_for = noted
        reset_launches(cb, fa)
        capture_s = sim.capture_step(hyper)
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        block = sim.run_rounds_fused(0, n_rounds, hyper)
        if cuda:
            torch.cuda.synchronize()
        block_s = time.perf_counter() - t0
        n = launches(cb, fa)
        (program,) = sim.programs.values()
        require(all(math.isfinite(m["loss_sum"]) for m in block)
                and all(torch.isfinite(v).all().item()
                        for v in sim.params.values()),
                f"faults flagship {leg}: non-finite metrics or params")
        ledger = sim.chaos_ledger.rounds()
        works, trained = [], set()
        for r in range(n_rounds):
            faults = ledger[r]["injected"] if ledger else {
                "dropped": [], "stragglers": {}}
            ws = {c: 0.0 if c in faults["dropped"]
                  else float(faults["stragglers"].get(c, 1.0))
                  for c in cohorts[r]}
            works.append(sum(ws.values()))
            want = sum(step_count(sim.batch_real[c], TrainHyper(
                cfg["learning_rate"], 1, w)) for c, w in ws.items() if w > 0)
            require(block[r]["local_steps"] == want,
                    f"faults flagship {leg} round {r}: "
                    f"{block[r]['local_steps']} local steps, the plan's "
                    f"work gives {want}: a dropped client ran a step")
            trained |= {c for c, w in ws.items() if w > 0}
            if sim.selection.track and sim.selection._pending:
                # a dropped client reported nothing (count 0): its slot
                # is empty, still queued on the device
                rec = sim.selection._pending[r]
                cnt = rec["slot_metrics"]["count"][0].cpu()
                require(all(float(cnt[k]) == 0.0 for k, c in
                            enumerate(rec["sampled"]) if ws[c] == 0.0),
                        f"faults flagship {leg} round {r}: a dropped "
                        f"client reported metrics")
        if sim.selection.track:
            sim.selection.flush()
            seen = {int(c) for c in np.flatnonzero(
                sim.selection.store.loss_count > 0)}
            require(seen == trained, f"faults flagship {leg}: the oort "
                                     f"store saw {len(seen)} clients, "
                                     f"{len(trained)} trained")
        evals = sim.contribution.evaluations
        n_eval = int(sim.test["x"].shape[0])
        forwards = program.warmup_steps + program.replays + evals * n_eval
        steps = sum(m["local_steps"] for m in block)
        if cuda:
            require(sim.dispatch_stats["captures"] == 1
                    and program.replays == steps
                    and program.graph_launches.get(cb.fused_block) == 27
                    and n["conv_block"] == 27 * forwards,
                    f"faults flagship {leg}: "
                    f"{sim.dispatch_stats['captures']} captures, "
                    f"{program.replays} replays for {steps} steps, B1 "
                    f"launched {n['conv_block']} times for {forwards} "
                    f"forward passes (27 each expected)")
        round_s = block_s / n_rounds
        rec = {"rounds": n_rounds, "block_s": block_s, "step_time_s": round_s,
               "rounds_per_hour": 3600.0 / round_s, "capture_s": capture_s,
               "local_steps": steps,
               "ms_per_local_step": block_s / max(steps, 1) * 1e3,
               "cohorts": [len(c) for c in cohorts],
               "dropped": [len(r["injected"]["dropped"]) for r in ledger],
               "stragglers": [len(r["injected"]["stragglers"])
                              for r in ledger],
               "work_sum": works, "b1_launches": n["conv_block"],
               "b1_per_forward": n["conv_block"] / max(forwards, 1),
               "forwards": forwards,
               "captures": sim.dispatch_stats["captures"],
               "adaptive": sim.selection.adaptive,
               "sample_cap": sim._sample_n}
        if sim.contribution.enabled:
            (hist,) = sim.contribution.history
            vals = hist["contributions"]
            require(len(vals) == len(cohorts[0])
                    and hist["client_ids"] == cohorts[0]
                    and math.isfinite(sum(vals))
                    and evals == len(vals) + 1,
                    f"faults flagship {leg}: LOO gave {len(vals)} values "
                    f"for {len(cohorts[0])} clients in {evals} evaluations")
            require(not sim.selection.adaptive
                    and sim._sample_n == cfg["client_num_per_round"],
                    f"faults flagship {leg}: the adaptive cohort is not "
                    f"pinned on the fused robust path")
            mat = sim._mat
            rec.update({"matrix_bytes": mat.numel() * mat.element_size(),
                        "loo_s": sum(loo_s), "evaluations": evals,
                        "loo_sum": sum(vals),
                        "loo_max": max(vals), "loo_min": min(vals),
                        "pinned": True})
        out[leg] = rec
        if leg == "chaos_oort":
            chaos_launches = n
        del sim, program
        if dev != "cpu":
            torch.cuda.empty_cache()
    return out, chaos_launches


def async_agreement(torch, dev=None, cpu="cpu", checks=None, base=None):
    """Phase 10 (a): the async engine on ResNet-20 (cuDNN on
    deterministic algorithms), each ASYNC_CHECKS configuration on the card
    against the CPU, then crash-resume. ``dev`` None is the card; ``cpu``
    the reference device. Returns {check: record}."""
    import tempfile

    import numpy as np
    from fedml_tpu_torch.core.chaos import ChaosCrash
    from fedml_tpu_torch.core.checkpoint import RoundCheckpointer
    checks = ASYNC_CHECKS if checks is None else checks
    base = ASYNC_CFG if base is None else base
    keys = ("round", "poured", "staleness_mean", "staleness_max",
            "virtual_t")
    out = {}
    torch.backends.cudnn.deterministic = True
    try:
        for label, kw in checks.items():
            cfg = dict(base, **kw)
            card = robust_simulator(cfg, dev)
            r_card = card.run()
            ref = robust_simulator(cfg, cpu)
            r_ref = ref.run()
            hist = [{k: h[k] for k in keys} for h in r_card["history"]]
            require(hist == [{k: h[k] for k in keys}
                             for h in r_ref["history"]]
                    and len(hist) == cfg["comm_round"]
                    and card.chaos_ledger.pours()
                    == ref.chaos_ledger.pours(),
                    f"async {label}: the pour records differ from the "
                    f"CPU's: {hist} vs {r_ref['history']}")
            ratio = _house_ratio(torch, card.params, ref.params)
            require(ratio <= 1.0, f"async {label}: card vs CPU {ratio:.2f}x "
                                  f"the house tolerance")
            rec = {"house_ratio": ratio,
                   "poured": [h["poured"] for h in hist],
                   "staleness_max": max(h["staleness_max"] for h in hist),
                   "virtual_t": r_card["virtual_time_s"],
                   **{k: card.async_stats[k]
                      for k in ("dropped", "stragglers", "local_steps")}}
            if card.verdicts:
                worst = max(float(np.max(np.abs(
                    card.verdicts[v][1].cpu().numpy()
                    - ref.verdicts[v][1].numpy()))) for v in card.verdicts)
                require(sorted(card.verdicts) == sorted(ref.verdicts)
                        and all(card.verdicts[v][0] == ref.verdicts[v][0]
                                for v in card.verdicts)
                        and worst <= 1e-3,
                        f"async {label}: verdicts differ from the CPU's "
                        f"(largest difference {worst:.2e})")
                rec["verdict_max_diff"] = worst
                rec["kept"] = [float(card.verdicts[v][1].sum().item())
                               for v in sorted(card.verdicts)]
            out[label] = rec

        cfg = dict(base, checkpoint_every_rounds=1)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_async_") as d:
            full = robust_simulator(dict(cfg, checkpoint_dir=f"{d}/full"),
                                    dev)
            full.run()
            crash = dict(cfg, checkpoint_dir=f"{d}/crash",
                         chaos_crash_at_round=1)
            try:
                robust_simulator(crash, dev).run()
                crashed = None
            except ChaosCrash as e:
                crashed = e.round_idx
            steps = RoundCheckpointer(f"{d}/crash", 1).steps()
            require(crashed == 1 and steps[-1] == 1,
                    f"async crash: raised at {crashed}, checkpoints {steps}")
            resumed = robust_simulator(crash, dev)
            r = resumed.run()
            require([h["round"] for h in r["history"]] == [2]
                    and all(torch.equal(full.params[k], resumed.params[k])
                            for k in full.params)
                    and full.virtual_t == resumed.virtual_t,
                    "async crash: the resumed run differs from the "
                    "uninterrupted one")
        out["crash_resume_bitwise"] = True
    finally:
        torch.backends.cudnn.deterministic = False
    return out


def async_flagship(torch, cb, fa, legs=ASYNC_LEGS, dev=None):
    """Phase 10 (b): the async engine at full width. Each leg's step is
    captured apart, the bootstrap pour (the first in-flight cohort) is
    timed apart, then its pours run through ``_pour_step`` (a defended
    pour's re-base + attack + defense between CUDA events). Returns {leg:
    record} and the kernels' launches per leg."""
    import numpy as np
    from fedml_tpu_torch import data
    from fedml_tpu_torch.arguments import Arguments
    from fedml_tpu_torch.core.algframe.types import TrainHyper
    out, per_leg = {}, {}
    fed, _ = data.load(Arguments(**legs[0][1]))
    for leg, cfg, n_pours in legs:
        sim = robust_simulator(cfg, dev, fed)
        cuda = sim.device.type == "cuda"
        hyper = TrainHyper(learning_rate=cfg["learning_rate"], epochs=1)
        events = []
        if sim._defended:
            inner = sim._defended_aggregate

            def timed(*a, _inner=inner, **kw):
                if not cuda:
                    return _inner(*a, **kw)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                res = _inner(*a, **kw)
                end.record()
                events.append((start, end))
                return res

            sim._defended_aggregate = timed
        reset_launches(cb, fa)
        capture_s = sim.capture_step(hyper)
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        sim._bootstrap(hyper)
        if cuda:
            torch.cuda.synchronize()
        boot_s = time.perf_counter() - t0
        boot_steps = sim.async_stats["local_steps"]
        t0 = time.perf_counter()
        recs = [sim._pour_step(hyper) for _ in range(n_pours)]
        if cuda:
            torch.cuda.synchronize()
        pours_s = time.perf_counter() - t0
        n = launches(cb, fa)
        (program,) = sim.programs.values()
        steps = sim.async_stats["local_steps"]
        timed_steps = steps - boot_steps
        poured = [r["poured"] for r in recs]
        require(all(p > 0 for p in poured) and sim.version == n_pours
                and all(torch.isfinite(v).all().item()
                        for v in sim.params.values())
                and all(math.isfinite(float(r["metrics"]["loss_sum"]))
                        for r in recs),
                f"async flagship {leg}: poured {poured} in {n_pours} pours, "
                f"or non-finite params / metrics")
        forwards = program.warmup_steps + steps
        if cuda:
            require(sim.dispatch_stats["captures"] == 1
                    and program.replays == steps
                    and program.graph_launches.get(cb.fused_block) == 27
                    and n["conv_block"] == 27 * forwards,
                    f"async flagship {leg}: "
                    f"{sim.dispatch_stats['captures']} captures, "
                    f"{program.replays} replays for {steps} steps, B1 "
                    f"launched {n['conv_block']} times for {forwards} "
                    f"forward passes (27 each expected)")
        st = sim.async_stats
        rec = {"pours": n_pours, "pours_s": pours_s,
               "s_per_pour": pours_s / n_pours,
               "pours_per_hour": 3600.0 * n_pours / pours_s,
               "updates_per_wall_hour": 3600.0 * sum(poured) / pours_s,
               "updates_per_sim_hour": (3600.0 * sim.updates_aggregated
                                        / sim.virtual_t),
               "virtual_t": sim.virtual_t, "poured": poured,
               "staleness_mean": float(np.mean([r["staleness_mean"]
                                                for r in recs])),
               "staleness_max": max(r["staleness_max"] for r in recs),
               "capture_s": capture_s, "bootstrap_s": boot_s,
               "bootstrap_steps": boot_steps, "timed_steps": timed_steps,
               "ms_per_local_step": pours_s / max(timed_steps, 1) * 1e3,
               "dispatched": st["dispatched"], "dropped": st["dropped"],
               "stragglers": st["stragglers"], "local_steps": steps,
               "b1_launches": n["conv_block"],
               "b1_per_forward": n["conv_block"] / max(forwards, 1),
               "forwards": forwards,
               "captures": sim.dispatch_stats["captures"]}
        if sim._defended:
            excluded = True
            for v, (ids, verdict) in sim.verdicts.items():
                byz = np.asarray(sim.attacker.byzantine_mask(
                    np.asarray(ids)), np.float32) > 0
                excluded &= bool(np.all(verdict.cpu().numpy()[byz] == 0.0))
            require(excluded and len(sim.verdicts) == n_pours,
                    f"async flagship {leg}: a byzantine row was kept "
                    f"({len(sim.verdicts)} verdicts)")
            if cuda:
                torch.cuda.synchronize()
            ms = [s.elapsed_time(e) for s, e in events]
            rec.update({
                "defense_ms_per_pour": (sum(ms) / len(ms)) if ms else None,
                "defense_ms": ms,
                "matrix_bytes": sim.k * sim._true_d * 4,
                "ring_bytes": sim._ring.numel() * sim._ring.element_size(),
                "ring_slots": sim._ring_r, "byzantine_excluded": excluded,
                "byzantine_poured": sum(
                    int(np.sum(np.asarray(sim.attacker.byzantine_mask(
                        np.asarray(ids))) > 0))
                    for ids, _ in sim.verdicts.values())})
        out[leg], per_leg[leg] = rec, n
        del sim, program
        if dev != "cpu":
            torch.cuda.empty_cache()
    return out, per_leg


def robust_bench(torch, base=ROBUST_BENCH, benches=ROBUST_BENCHES,
                 block=ROBUST_BENCH_BLOCK, dev=None):
    """Phase 8 (c): bench.py's ``bench_robust_defended`` legs on the port:
    the fused path (``robust_fused: auto``) and the host path (``host``),
    a warm-up block then two timed blocks each; ``vs_baseline`` = the
    host path's seconds per round over the fused path's."""
    import numpy as np

    from fedml_tpu_torch.core.algframe.types import TrainHyper
    out = {}
    for metric, kw in benches.items():
        legs = {}
        for mode in ("auto", "host"):
            sim = robust_simulator(dict(base, robust_fused=mode, **kw), dev)
            hyper = TrainHyper(learning_rate=base["learning_rate"])
            sim.run_rounds_fused(0, block, hyper)
            trials = []
            for i in (1, 2):
                if sim.device.type == "cuda":
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                sim.run_rounds_fused(i * block, block, hyper)
                if sim.device.type == "cuda":
                    torch.cuda.synchronize()
                trials.append((time.perf_counter() - t0) / block)
            legs[mode] = (min(trials), trials, sim)
        (fs, ftr, f), (hs, htr, h) = legs["auto"], legs["host"]
        require(f.robust_fused and not h.robust_fused,
                f"{metric}: the legs took the same path")
        diff = _largest(torch, f.params, h.params)
        same = sorted(f.verdicts) == sorted(h.verdicts) and all(
            np.array_equal(f.verdicts[r][1], h.verdicts[r][1])
            for r in f.verdicts)
        require(same and diff < 1e-5, f"{metric}: fused and host paths "
                                      f"differ (params by {diff:.3e})")
        out[metric] = {
            "value": 3600.0 / fs, "unit": "defended rounds/hour (16 "
            f"clients, fused {block}-round block)",
            "vs_baseline": hs / fs,
            "host_path_rounds_per_hour": 3600.0 / hs,
            "step_time_s": fs, "host_path_step_time_s": hs,
            "fused_trials": ftr, "host_trials": htr,
            "params_max_abs_diff": diff, "verdicts_identical": same,
            "n_devices": 1}
    return out


def build_all(build, names):
    """One nvcc per source, all started together; print each build's
    time and the compiler's register, shared-memory and spill lines.
    Returns {kernel (mangled name): bytes spilled (stores + loads)}."""
    from concurrent.futures import ThreadPoolExecutor

    def one(name):
        t0 = time.time()
        return name, build.build(name), time.time() - t0

    with ThreadPoolExecutor(len(names)) as pool:
        done = list(pool.map(one, names))
    spilled, fn = {}, None
    for name, lib, dt in done:
        print(f"build: {name}.cu in {dt:.1f} s -> {lib.name}", flush=True)
        for line in lib.with_suffix(".log").read_text().splitlines():
            if any(w in line for w in ("entry function", "registers",
                                       "spill", "smem")):
                print(f"  ptxas: {line.strip()}")
            if "Function properties for" in line:
                fn = line.split("Function properties for")[-1].strip()
            elif "spill stores" in line and fn is not None:
                # "0 bytes stack frame, 0 bytes spill stores, 0 bytes
                # spill loads"
                words = line.replace(",", " ").split()
                spilled[fn] = sum(int(words[i - 2]) for i, w in
                                  enumerate(words) if w == "spill")
    return spilled


def attn_inputs(torch, gen, shape, dtype):
    """q, k, v, dO on the card in ``dtype`` and the f32 key mask (or
    None), drawn on the CPU from ``gen``."""
    b, s, h, d, mask = shape
    dt = getattr(torch, dtype)
    q, k, v, g = (torch.randn(b, s, h, d, generator=gen).to("cuda", dt)
                  for _ in range(4))
    if mask == "none":
        m = None
    elif mask == "random":
        m = (torch.rand(b, s, generator=gen) > 0.3).float()
        m[:, 0] = 1.0
    else:  # "prefix<n>": the first n keys masked
        m = torch.ones(b, s)
        m[:, :int(mask[len("prefix"):])] = 0.0
    return q, k, v, g, None if m is None else m.to("cuda")


def rel_err(torch, got, ref):
    return ((got.float() - ref).abs().max() /
            ref.abs().max().clamp(min=1e-30)).item()


def check_attention(torch, fa, attn, gen, shape, dtype):
    """B2-B4 against their plain versions in f32 on the same inputs, the
    exact zeros of rows with no live key and of masked keys, and the
    autograd Function against dense attention. Returns (max abs error of
    O, of dQ, of dK/dV)."""
    b, s, h, d, mask = shape
    q, k, v, g, m = attn_inputs(torch, gen, shape, dtype)
    o, lse = fa.flash_fwd(q, k, v, m)
    torch.cuda.synchronize()
    require(o.dtype == q.dtype and tuple(o.shape) == (b, s, h, d)
            and tuple(lse.shape) == (b, h, s), f"{shape}: bad output")
    qf, kf, vf, gf = (t.float() for t in (q, k, v, g))
    ro, rlse = fa.reference_fwd(qf, kf, vf, m)
    err = (o.float() - ro).abs()
    require(torch.isfinite(o.float()).all().item(), f"{shape}: non-finite O")
    if dtype == "float32":
        rtol, atol = ATTN_FWD_TOL
        bad = int((err > atol + rtol * ro.abs()).sum())
        require(bad == 0, f"{shape} {dtype}: {bad} outputs of O beyond "
                          f"tolerance (max abs err {err.max().item():.3e})")
    else:
        oerr = rel_err(torch, o, ro)
        require(oerr <= ATTN_GRAD_TOL[dtype],
                f"{shape} {dtype}: O off by {oerr:.3e} of its largest entry")
    require(torch.isfinite(lse).all().item(), f"{shape}: non-finite LSE")
    lerr = (lse - rlse).abs()
    bad = int((lerr > ATTN_LSE_TOL[1] + ATTN_LSE_TOL[0] * rlse.abs()).sum())
    require(bad == 0, f"{shape} {dtype}: LSE off by {lerr.max().item():.3e}")
    dd = (g.float() * o.float()).sum(-1)
    dq = fa.flash_dq(q, k, v, m, g, lse, dd)
    dk, dv = fa.flash_dkv(q, k, v, m, g, lse, dd)
    torch.cuda.synchronize()
    require(all(torch.isfinite(t.float()).all().item() for t in (dq, dk, dv)),
            f"{shape} {dtype}: non-finite gradients")
    rdq = fa.reference_dq(qf, kf, vf, m, gf, lse, dd)
    rdk, rdv = fa.reference_dkv(qf, kf, vf, m, gf, lse, dd)
    gerr = max(rel_err(torch, a, r) for a, r in ((dq, rdq), (dk, rdk),
                                                 (dv, rdv)))
    require(gerr <= ATTN_GRAD_TOL[dtype],
            f"{shape} {dtype}: gradient error {gerr:.3e}")
    if m is not None:
        dead = (m == 0)[:, :, None, None].expand_as(dk)
        require(bool((dk[dead] == 0).all()) and bool((dv[dead] == 0).all()),
                f"{shape} {dtype}: masked keys got nonzero dK/dV")
    if mask.startswith("prefix"):
        n = int(mask[len("prefix"):])
        require(bool((o[:, :n] == 0).all()) and bool((dq[:, :n] == 0).all()),
                f"{shape} {dtype}: rows with no live key are not exactly 0")
        require(bool((lse[:, :, :n] < -1e29).all()),
                f"{shape} {dtype}: LSE of rows with no live key not -1e30")
    if not mask.startswith("prefix") and (
            dtype == "float32" and s <= 1024 or shape in (ATTN_MAIN,
                                                           ATTN_HOT)):
        # the autograd Function (D from the stored O, then B3 and B4) in
        # `dtype` against dense attention under autograd in f32 on the same
        # values: output and gradients
        outs, grads = [], []
        for fn, dt in ((attn.flash_causal_attention, q.dtype),
                       (attn.dense_causal_attention, torch.float32)):
            leaves = [t.detach().to(dt).requires_grad_() for t in (q, k, v)]
            out = fn(*leaves, attn_mask=m)
            outs.append(out.detach())
            grads.append(torch.autograd.grad((out.float() * gf).sum(),
                                             leaves))
        aerr = max(rel_err(torch, a, r) for a, r in zip(
            [outs[0], *grads[0]], [outs[1], *grads[1]]))
        require(aerr <= ATTN_GRAD_TOL[dtype],
                f"{shape} {dtype}: flash vs dense autograd output and "
                f"gradients off by {aerr:.3e}")
    return (err.max().item(), (dq.float() - rdq).abs().max().item(),
            max((dk.float() - rdk).abs().max().item(),
                (dv.float() - rdv).abs().max().item()))


def attention_cost(shape, itemsize, kernel):
    """(bytes, causal FLOPs) the kernel's function must move and do: each
    input read once and each output written once; 2·b·h·(s²/2)·d per
    product, 2 products for B2, 3 for B3 and 4 for B4."""
    b, s, h, d, _ = shape
    t = b * s * h * d * itemsize
    row = b * h * s * 4
    tensors, rows, products = {"fwd": (4, 1, 2), "dq": (5, 2, 3),
                               "dkv": (6, 2, 4)}[kernel]
    return tensors * t + rows * row, products * b * h * s * s * d


def device_ms(torch, fn, stream=None, iters=20, warmup=3):
    """(device time of one call of ``fn``, names of the kernels it runs):
    ``iters`` calls captured once into a CUDA graph on ``stream`` (a new
    side stream by default), the graph replayed once to warm it and then
    once more between two CUDA events. Replaying a graph launches its
    kernels back to back with no host in between, so unlike a clock around
    eager calls it leaves out the host's launch overhead. The names come
    from the graph's DOT dump (one node per kernel launch)."""
    import re

    stream = stream or torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(warmup):
            fn()
    torch.cuda.synchronize()
    # keep_graph: the captured graph outlives capture_end, for debug_dump
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(iters):
            fn()
    graph.instantiate()
    text = graph_dot(graph)
    names = {t for t in re.split(r'[\s"|{}]+', text) if "kernel" in t}
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    graph.reset()
    ms = start.elapsed_time(end) / iters
    require(ms > 0 and names, f"the CUDA graph recorded no kernel "
                              f"({ms} ms; its DOT dump: {text[:800]!r})")
    return ms, names


def graph_dot(graph) -> str:
    """The DOT dump of a CUDA graph captured with ``keep_graph=True``: one
    node per kernel launch (or copy, or memset), on one line each."""
    dot = os.path.join("build", "graph.dot")
    os.makedirs("build", exist_ok=True)
    graph.debug_dump(dot)
    require(os.path.exists(dot), "the CUDA graph wrote no DOT dump")
    with open(dot) as f:
        text = f.read()
    os.unlink(dot)
    return text


def time_attention(torch, F, fa, gen, shape, dtype):
    """Per kernel, at ``shape`` in ``dtype``: ms of the kernel (CUDA events
    around back-to-back calls of its wrapper, so the wrapper's host time
    where it exceeds the kernel's) and its device time, its plain version,
    the library call's device time and the bound."""
    q, k, v, g, m = attn_inputs(torch, gen, shape, dtype)
    with torch.no_grad():
        o, lse = fa.flash_fwd(q, k, v, m)
        dd = (g.float() * o.float()).sum(-1)
    args = (q, k, v, m, g, lse, dd)
    # the yardstick: PyTorch's fused attention on [b, h, s, d] copies,
    # forward, and its autograd backward (dQ, dK, dV together), both as
    # device time. The forward whose backward is timed runs on the stream
    # the backward is captured on: autograd runs a backward op on its
    # forward's stream.
    ql, kl, vl = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    gl = g.transpose(1, 2).contiguous()
    with torch.no_grad():
        lib_fwd, _ = device_ms(torch, lambda: F.scaled_dot_product_attention(
            ql, kl, vl, is_causal=True))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ol = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True)
    lib_bwd, _ = device_ms(torch, lambda: torch.autograd.grad(
        ol, (ql, kl, vl), gl, retain_graph=True), stream=side)
    rows = {}
    with torch.no_grad():
        for kernel, fn, plain, lib in (
                ("fwd", lambda: fa.flash_fwd(q, k, v, m),
                 lambda: fa.reference_fwd(q, k, v, m), lib_fwd),
                ("dq", lambda: fa.flash_dq(*args),
                 lambda: fa.reference_dq(*args), lib_bwd),
                ("dkv", lambda: fa.flash_dkv(*args),
                 lambda: fa.reference_dkv(*args), lib_bwd)):
            nbytes, ops = attention_cost(shape, q.element_size(), kernel)
            t_bytes = nbytes / PEAK_BYTES * 1e3
            t_ops = ops / PEAK_OPS[dtype] * 1e3
            dev, names = device_ms(torch, fn)
            # one kernel per (kernel, dtype): bf16 B2-B4 are the
            # tensor-core kernels
            want = KERNEL_NAME[dtype][kernel]
            require(any(want in n for n in names) and not any(
                "flash" in n and want not in n for n in names),
                f"{kernel} in {dtype} ran {names}, not {want}")
            rows[kernel] = dict(
                ms=time_ms(torch, fn, iters=20), device_ms=dev,
                plain_ms=time_ms(torch, plain, iters=3, warmup=1),
                library_ms=lib, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")
    return rows


def reset_launches(cb, fa):
    for fn in (cb.fused_block, fa.flash_fwd, fa.flash_dq, fa.flash_dkv):
        fn.launches = 0


def launches(cb, fa):
    return {"conv_block": cb.fused_block.launches,
            "flash_fwd": fa.flash_fwd.launches,
            "flash_dq": fa.flash_dq.launches,
            "flash_dkv": fa.flash_dkv.launches}


def tiny_llm_agreement(torch, run_federated_llm, Arguments):
    """The federated LoRA fine-tune on the card (B2-B4, f32) against the
    same run on the CPU (plain versions), from the same seeded base and
    adapters: 2 silos, 1 round, d 32, 1 layer, SGD at lr 0.05. The run is
    one round of plain SGD, so card-vs-CPU differences stay at float32
    reordering; bound rtol 1e-3, atol 1e-5 on every adapter entry."""
    cfg = dict(dataset="llm_synth", model="causal_lm",
               client_num_in_total=2, client_num_per_round=2, comm_round=1,
               epochs=1, batch_size=8, learning_rate=0.05,
               llm_corpus_size=48, llm_max_seq_len=40, llm_hidden_size=32,
               llm_num_layers=1, llm_num_heads=2, llm_intermediate_size=64,
               lora_rank=4, random_seed=5, frequency_of_the_test=1,
               llm_attention_impl="flash")
    gpu = run_federated_llm(Arguments(**cfg))
    cpu = run_federated_llm(Arguments(**cfg), device="cpu")
    worst, moved = 0.0, 0.0
    for key, c in cpu["params"].items():
        g = gpu["params"][key].cpu()
        worst = max(worst, ((g - c).abs() / (1e-5 + 1e-3 * c.abs()))
                    .max().item())
        if key.endswith("lora_b"):
            moved = max(moved, c.abs().max().item())
    require(moved > 0, "tiny LLM run: the adapters did not move")
    require(worst <= 1.0, f"tiny LLM run: card vs CPU adapters off by "
                          f"{worst:.2f}x the tolerance")
    hg, hc = gpu["history"][0], cpu["history"][0]
    require(abs(hg["test_loss"] - hc["test_loss"]) <= 1e-4 * abs(
        hc["test_loss"]), "tiny LLM run: test loss differs")
    return worst, hg["test_loss"], hc["test_loss"]


def export_check(torch, result, export_dir):
    """The FedLLM run's export: ``global``, ``silo_0`` and ``silo_1``
    reload bitwise equal to the adapters the run holds, and ``global`` is
    the run's ``params``. Returns counts, bytes and the export's
    seconds."""
    from fedml_tpu_torch.core.distributed.communication.message import \
        array_to_tensor
    from fedml_tpu_torch.interop import flax_to_state_dict
    from fedml_tpu_torch.llm.federated import load_adapter_artifacts

    held = result["adapter_export"]["adapters"]
    loaded = load_adapter_artifacts(export_dir)
    require(sorted(loaded) == sorted(held) == ["global", "silo_0", "silo_1"],
            f"export: adapters {sorted(loaded)}")
    require(all(torch.equal(held["global"][k], v)
                for k, v in result["params"].items()),
            "export: global is not the run's params")
    for name, tree in loaded.items():
        flat = flax_to_state_dict(tree)
        require(set(flat) == set(held[name]) and all(
            torch.equal(array_to_tensor(flat[k]), v.cpu())
            for k, v in held[name].items()),
            f"export: {name} does not reload bitwise")
    nbytes = sum(os.path.getsize(os.path.join(export_dir, f))
                 for f in os.listdir(export_dir))
    return {"adapters": len(loaded), "bytes": nbytes,
            "bytes_per_adapter": os.path.getsize(
                os.path.join(export_dir, "global.fmtpu")),
            "lora_params": sum(v.numel() for v in result["params"].values()),
            "wall_s": result["adapter_export"]["wall_s"]}


def hot_loop(torch, llm, cb, fa):
    """HOT_STEPS SGD steps (lr 1e-3) of the 111M causal LM on one batch of
    seeded random tokens, full parameters, as bench.py's
    _llm_train_step_timing does. Returns (ms per step over all but the
    first step, losses, launches, parameter count)."""
    from torch.func import functional_call

    cfg = llm.LLMConfig(**HOT_LOOP)
    model, params = llm.init_llm(cfg, torch.Generator().manual_seed(0))
    model.to("cuda")
    params = {k: v.to("cuda") for k, v in params.items()}
    spec = llm.CausalLMTrainer(
        lambda p, x, train=False: functional_call(model, p, (x,)))
    gen = torch.Generator().manual_seed(1)
    seq = cfg.max_seq_len
    batch = {"x": torch.randint(0, cfg.vocab_size, (HOT_BATCH, seq),
                                generator=gen).cuda(),
             "y": torch.randint(0, cfg.vocab_size, (HOT_BATCH, seq),
                                generator=gen).cuda(),
             "mask": torch.ones(HOT_BATCH).cuda()}
    losses = []
    reset_launches(cb, fa)
    t0 = None
    for step in range(HOT_STEPS):
        if step == 1:
            torch.cuda.synchronize()
            t0 = time.time()
        leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
        loss, _ = spec.loss(leaves, batch)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        with torch.no_grad():
            params = {k: v - 1e-3 * gr for (k, v), gr in
                      zip(params.items(), grads)}
        losses.append(loss.item())
    torch.cuda.synchronize()
    ms = (time.time() - t0) / (HOT_STEPS - 1) * 1e3
    return ms, losses, launches(cb, fa), llm.count_params(params), params


def codec_speed(torch, params, tmp):
    """Phase 13, after the hot loop: ``save_model`` then ``load_model`` of the hot loop's
    params (f32, on the card): seconds and MB/s of each direction (the
    device-to-host copy inside the save), the round trip bitwise."""
    from fedml_tpu_torch.core.distributed.communication.message import \
        array_to_tensor
    from fedml_tpu_torch.interop import flax_to_state_dict
    from fedml_tpu_torch.serving import load_model, save_model

    path = os.path.join(tmp, "hot_loop.fmtpu")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    save_model(params, path)
    save_s = time.perf_counter() - t0
    nbytes = os.path.getsize(path)
    t0 = time.perf_counter()
    tree = load_model(path)
    load_s = time.perf_counter() - t0
    flat = flax_to_state_dict(tree)
    require(set(flat) == set(params) and all(
        torch.equal(array_to_tensor(flat[k]), v.cpu())
        for k, v in params.items()), "codec: the round trip is not bitwise")
    os.remove(path)
    mb = nbytes / 1e6
    return {"bytes": nbytes, "save_s": save_s, "load_s": load_s,
            "save_mb_per_s": mb / save_s, "load_mb_per_s": mb / load_s}



def cache_arithmetic(torch, kvc):
    """The paged cache's gather, the three scatters and the copy-on-write
    at the serving geometry (64 slots, blocks of 16, seq 256, 8 heads of
    64, bf16 pools) on the card against the same calls on the CPU, on
    seeded inputs: integer indexing and copies, so bitwise (the trash
    block, where several dropped rows land on one row, left out)."""
    cfg = kvc.KVCacheConfig(num_layers=4, kv_heads=8, head_dim=64,
                            max_seq_len=256, block_size=16,
                            num_blocks=64 * 16)
    gen = torch.Generator().manual_seed(11)
    shape = (cfg.num_layers, cfg.num_blocks + 1, cfg.block_size, 8, 64)
    pool = torch.randn(shape, generator=gen).bfloat16()
    s, mb, bs, trash = 64, cfg.max_blocks_per_slot, 16, cfg.trash_block
    tables = torch.randperm(cfg.num_blocks, generator=gen)[:s * mb].reshape(
        s, mb).int()
    tables[5:9, 6:] = trash                   # short rows: trash tails
    pos = torch.randint(0, 256, (s,), generator=gen).int()
    active = torch.rand(s, generator=gen) > 0.2
    tok = torch.randn(s, 8, 64, generator=gen)
    chunk = torch.randn(8, 32, 8, 64, generator=gen)
    p0 = torch.randint(0, 224, (8,), generator=gen).int()
    cpos = p0[:, None] + torch.arange(32).int()[None, :]
    valid = torch.arange(32)[None, :] < torch.randint(
        0, 33, (8, 1), generator=gen)

    def run(dev):
        kp, tb = pool.to(dev).clone(), tables.to(dev)
        out = [kvc.gather_view(kp[2], tb)]
        kvc.scatter_token(kp, 1, tb, pos.to(dev), tok.to(dev),
                          active.to(dev), bs, trash)
        kvc.scatter_chunk(kp, 3, tb[7], cpos[0].to(dev), chunk[0].to(dev),
                          valid[0].to(dev), bs, trash)
        kvc.scatter_chunk_batch(kp, 0, tb[:8], cpos.to(dev), chunk.to(dev),
                                valid.to(dev), bs, trash)
        kvc.copy_block_rows(kp, int(tables[0, 0]), int(tables[1, 1]), 7)
        out.append(kp[:, :cfg.num_blocks])
        return [t.cpu() for t in out]

    for a, b in zip(run("cuda"), run("cpu")):
        require(torch.equal(a, b), "cache arithmetic: card and CPU differ")
    return s


def decode_vs_forward(torch, build_llm_bundle, Arguments, DecodeScheduler,
                      AdapterBank, args, adapter, dtype, dev="cuda"):
    """One decode step's logits for one slot against the full forward over
    the padded ``[1, max_seq_len]`` buffer at the same position (single
    mode's step), on the card; error relative to the row's largest
    logit."""
    from fedml_tpu_torch.llm.data import BOS, SEP
    bundle, tok = build_llm_bundle(Arguments(**args))
    bundle.to(dev)
    bank, params = None, bundle.base_params
    if adapter is None:     # full fine-tune: the params ARE the model
        params = {k: v.detach() for k, v in bundle.module.state_dict().items()}
    else:
        bank = AdapterBank(adapter, alpha=bundle.lora_alpha, capacity=2)
        bank.add("a", adapter)
    sched = DecodeScheduler(bundle.module, bundle.cfg, params, bank,
                            slots=4, block_size=16, prefill_chunk=32,
                            device=dev)
    ids = [BOS] + tok.encode("echo hello world, and then some") + [SEP]
    slot, first = sched.admit(ids, adapter_idx=0 if bank is None else 1,
                              max_new_tokens=8)
    with torch.no_grad():
        _, _, _, _, row = sched._step_fn(
            sched.params, sched._stack(), sched._kp, sched._vp,
            sched._dev(sched._tables), sched._dev(sched._pos),
            sched._dev(sched._active), sched._dev(sched._aidx).long(),
            sched._dev(sched._last), *sched._sampling(
                sched._temp, sched._seed, sched._pos + 1))
        buf = torch.zeros(1, bundle.cfg.max_seq_len, dtype=torch.int32,
                          device=dev)
        buf[0, :len(ids) + 1] = torch.tensor(ids + [first])
        ref = bundle.apply(params if adapter is None else adapter,
                           buf)[0, len(ids)]
    err = ((row[slot] - ref).abs().max() / ref.abs().max()).item()
    require(math.isfinite(err) and err <= DECODE_TOL[dtype],
            f"decode step vs full forward ({dtype}): {err:.3e} of the "
            f"largest logit > {DECODE_TOL[dtype]}")
    return err


def greedy_parity(torch, build_llm_bundle, Arguments, CausalLMPredictor,
                  dev="cuda"):
    """Batch-mode greedy tokens against single-mode tokens on a full
    fine-tune artifact (f32, dense, the FedLLM main path's width) for
    tests/test_serving_batch.py's four prompts, 12 new tokens each. cuBLAS
    may round the two shapes differently, so the two may part only where
    the single path's top-2 logit gap is below TIE_GAP; returns each
    parting (prompt, step, gap). Any other divergence fails."""
    from fedml_tpu_torch.llm.data import EOS
    args = dict(LLM_MAIN_PATH, precision="float32", lora_rank=0,
                llm_attention_impl="dense")
    bundle, tok = build_llm_bundle(Arguments(**args))
    params = {k: v.detach() for k, v in bundle.module.state_dict().items()}
    single = CausalLMPredictor(bundle, params, tokenizer=tok, device=dev)
    batch = CausalLMPredictor(bundle, params, tokenizer=tok, mode="batch",
                              batch_opts=dict(SERVE_BATCH, slots=4),
                              device=dev)
    parted = []

    def buf_of(ids):
        buf = torch.zeros(1, bundle.cfg.max_seq_len, dtype=torch.int32,
                          device=dev)
        buf[0, :len(ids)] = torch.tensor(ids)
        return buf

    try:
        for prompt in PARITY_PROMPTS:
            ids = single._encode_prompt(prompt, 12)
            a = []
            while len(a) < 12:   # single mode's own greedy step
                nxt = single._step(buf_of(ids + a), len(ids + a), 0.0, None)
                if nxt == EOS:
                    break
                a.append(nxt)
            b = batch.engine.submit(ids, max_new_tokens=12).result(
                timeout=SERVE_BATCH["request_timeout_s"])["ids"]
            if a == b:
                continue
            j = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                     min(len(a), len(b)))
            with torch.no_grad():
                top = bundle.apply(params, buf_of(ids + a[:j]))[
                    0, len(ids) + j - 1].topk(2).values
            gap = (top[0] - top[1]).item()
            print(f"greedy parity: {prompt!r} parts at generated token {j} "
                  f"(single top-2 gap {gap:.3e})", flush=True)
            require(gap < TIE_GAP, f"greedy parity: {prompt!r} single {a} "
                                   f"vs batch {b}, top-2 gap {gap:.3e}")
            parted.append({"prompt": prompt, "step": j, "gap": gap})
    finally:
        batch.close()
    return parted


def isolation(torch, bundle, tok, bank, DecodeScheduler, dev="cuda"):
    """Two requests for two different adapters of the 64-adapter bank, run
    side by side in one decode step, each equal their solo runs (and the
    two differ)."""
    from fedml_tpu_torch.llm.data import BOS, SEP
    tok_ids = [BOS] + tok.encode("echo hello world") + [SEP]
    base = bundle.base_params
    names = ("silo_3", "silo_40")

    def run(which):
        sched = DecodeScheduler(bundle.module, bundle.cfg, base, bank,
                                slots=4, block_size=16, prefill_chunk=32,
                                device=dev)
        out = {}
        for n in which:
            slot, first = sched.admit(tok_ids, adapter_idx=bank.index(n),
                                      max_new_tokens=12)
            out[n] = (slot, [first])
        for _ in range(11):
            toks = sched.step()
            for n, (slot, seq) in out.items():
                seq.append(toks[slot])
        return {n: seq for n, (_, seq) in out.items()}

    pair = run(names)
    for n in names:
        require(run((n,))[n] == pair[n],
                f"isolation: {n} alongside another adapter != its solo run")
    require(pair[names[0]] != pair[names[1]],
            "isolation: two different adapters gave the same tokens")
    return True


def serve_sweep(pred, prompts, conc, adapter_names, max_new=SERVE_MAX_NEW):
    """``conc`` requests at concurrency ``conc`` (bench_llm_serving's
    sweep): generated tokens/s over the sweep's wall and the p99 request
    latency from the sweep's start; returns it with the outputs."""
    import concurrent.futures as cf
    t0 = time.perf_counter()
    lats, outs = [0.0] * conc, [None] * conc

    def one(i):
        outs[i] = pred.generate(prompts[i], max_new_tokens=max_new,
                                adapter=adapter_names[i % len(adapter_names)])
        lats[i] = time.perf_counter() - t0

    with cf.ThreadPoolExecutor(conc) as ex:
        for f in [ex.submit(one, i) for i in range(conc)]:
            f.result(timeout=SERVE_BATCH["request_timeout_s"])
    wall = time.perf_counter() - t0
    toks = sum(o["completion_tokens"] for o in outs)
    p99 = sorted(lats)[min(conc - 1, int(0.99 * (conc - 1) + 0.5))]
    return {"tokens_per_s": toks / wall, "p99_latency_s": p99,
            "tokens": toks, "wall_s": wall}, outs


def greedy_texts(pred, adapter, n=12):
    return [pred.generate(p, max_new_tokens=n, adapter=adapter)["text"]
            for p in PARITY_PROMPTS]


def serving_phase(torch, llm, cb, fa, Arguments, export, dev="cuda"):
    """The serving path at the FedLLM main path's width: the base the run
    froze and the adapters it exported. Single mode (the sequential
    baseline, one request at a time as bench_llm_serving's lock does) on
    the run's global adapter, then batch mode built from the exported
    artifacts by ``from_artifact`` (its greedy tokens for no adapter,
    silo_0 and silo_1 first held to a predictor built in memory from the
    run's own adapters) with banks of 1 and 64 adapters, then the churn
    leg. Returns the serving line and the kernels' launches over the
    single-mode legs."""
    import threading
    from fedml_tpu_torch.serving.batch import AdapterBank, DecodeScheduler
    from fedml_tpu_torch.serving.llm_template import CausalLMPredictor

    adapter = export["adapters"]["global"]
    export_dir = os.path.dirname(export["manifest"])
    bundle, tok = llm.build_llm_bundle(Arguments(**LLM_MAIN_PATH))
    legs, steps, ttft = {}, {}, {}
    lock = threading.Lock()
    single = CausalLMPredictor(bundle, adapter, tokenizer=tok, device=dev)
    single.generate("warm", max_new_tokens=2)

    def serial(prompt, max_new_tokens, adapter=None):
        with lock:   # the single path serves one request at a time
            return single.generate(prompt, max_new_tokens=max_new_tokens)

    class Serial:
        generate = staticmethod(serial)

    reset_launches(cb, fa)
    forwards = 0
    for c in SERVE_CONC:
        legs[f"sequential_c{c}"], outs = serve_sweep(Serial, SERVE_PROMPTS,
                                                     c, [None])
        forwards += sum(o["completion_tokens"] + (o["finish_reason"] ==
                                                  "stop") for o in outs)
    single_launches = launches(cb, fa)
    layers = LLM_MAIN_PATH["llm_num_layers"]
    require(single_launches == {"conv_block": 0, "flash_fwd": layers *
                                forwards, "flash_dq": 0, "flash_dkv": 0},
            f"single mode launches {single_launches}, expected "
            f"{layers} x {forwards} of B2 only")

    serve_args = Arguments(**dict(LLM_MAIN_PATH, llm_adapter_dir=export_dir,
                                  **SERVE_ARGS))
    t0 = time.perf_counter()
    pred = CausalLMPredictor.from_artifact(
        serve_args, os.path.join(export_dir, "global.fmtpu"), device=dev)
    load_s = time.perf_counter() - t0
    gen = torch.Generator().manual_seed(1)
    bank64 = None
    batch_launches = {}
    try:
        mem_bank = AdapterBank(adapter, alpha=bundle.lora_alpha,
                               capacity=SERVE_BATCH["max_adapters"])
        for name in ("silo_0", "silo_1"):
            mem_bank.add(name, export["adapters"][name])
        mem = CausalLMPredictor(bundle, adapter, tokenizer=tok,
                                mode="batch", batch_opts=SERVE_BATCH,
                                adapter_bank=mem_bank, device=dev)
        try:
            for name in (None, "silo_0", "silo_1"):
                require(greedy_texts(pred, name) == greedy_texts(mem, name),
                        f"from_artifact: greedy tokens for adapter {name} "
                        f"differ from the in-memory predictor's")
        finally:
            mem.close()
        for tag, n_bank in (("bank1", 1), ("bank64", 64)):
            names = [None]
            if n_bank > 1:
                for a in range(n_bank):
                    pred.adapter_bank.add(f"silo_{a}", {
                        k: 0.1 * torch.randn(v.shape, generator=gen)
                        for k, v in adapter.items()})
                names = [f"silo_{a}" for a in range(n_bank)]
                bank64 = pred.adapter_bank
            pred.generate("warm", max_new_tokens=2, adapter=names[0])
            engine = pred.engine
            steps0 = engine.scheduler.steps_run
            reset_launches(cb, fa)
            for c in SERVE_CONC:
                engine._ttft_window = type(engine._ttft_window)(
                    window_s=3600.0)
                legs[f"batched_{tag}_c{c}"], outs = serve_sweep(
                    pred, SERVE_PROMPTS, c, names)
                require(all(o["completion_tokens"] > 0 for o in outs),
                        f"batched {tag} c{c}: a request generated nothing")
                if c == 8:
                    _, mean, p50, p99, n = engine._ttft_window.stats()
                    ttft[tag] = {"mean_s": mean, "p50_s": p50, "p99_s": p99,
                                 "n": n}
            batch_launches[tag] = launches(cb, fa)
            steps[tag] = engine.scheduler.steps_run - steps0
            require(engine.health()["status"] == "ok",
                    f"batched {tag}: engine {engine.health()}")
            require(not any(batch_launches[tag].values()),
                    f"batch mode launched {batch_launches[tag]}: its "
                    f"attention is cached_attention, no kernel")
    finally:
        pred.close()
    iso = isolation(torch, bundle, tok, bank64, DecodeScheduler, dev)
    churn = churn_leg(torch, Arguments, bundle, tok, adapter, export_dir,
                      dev)
    top = max(SERVE_CONC)
    line = {"legs": legs, "ttft_c8": ttft, "decode_steps": steps,
            "b2_launches_single": single_launches["flash_fwd"],
            "single_forwards": forwards, "isolation": iso,
            "from_artifact_load_s": load_s,
            "from_artifact_parity_prompts": len(PARITY_PROMPTS),
            "churn": churn,
            "speedup_c64": legs[f"batched_bank1_c{top}"]["tokens_per_s"]
            / legs[f"sequential_c{top}"]["tokens_per_s"]}
    return line, single_launches


def churn_leg(torch, Arguments, bundle, tok, adapter, export_dir, dev):
    """CHURN traffic on a predictor built by ``from_artifact`` over a
    watched directory of 8 seeded adapters: one churn-free sweep (after a
    warm one), then 4 sweeps each with one adapter re-exported into the
    directory mid-traffic by ``save_adapter_artifacts``. The watcher must
    apply 4 swaps, the engine stay healthy, and the last churned adapter's
    greedy tokens equal a fresh predictor's loaded with its new
    version."""
    import concurrent.futures as cf
    from fedml_tpu_torch.llm.federated import save_adapter_artifacts
    from fedml_tpu_torch.serving.batch import AdapterBank
    from fedml_tpu_torch.serving.llm_template import CausalLMPredictor

    gen = torch.Generator().manual_seed(7)

    def rand_adapter():
        return {k: 0.1 * torch.randn(v.shape, generator=gen)
                for k, v in adapter.items()}

    conc, max_new, rounds = (CHURN["concurrency"], CHURN["max_new"],
                             CHURN["rounds"])
    watched = os.path.join(os.path.dirname(export_dir), "churn")
    names = [f"silo_{a}" for a in range(CHURN["bank"])]
    save_adapter_artifacts({n: rand_adapter() for n in names}, watched)
    # bank rows: the adapters, a fresh row per swap (retired rows rejoin
    # the pool once their last in-flight pin drops), default and spare
    capacity = CHURN["bank"] + rounds + 4
    args = Arguments(**dict(LLM_MAIN_PATH, **dict(
        SERVE_ARGS, llm_adapter_dir=watched, serving_max_adapters=capacity,
        llm_adapter_watch_s=CHURN["poll_s"])))
    pred = CausalLMPredictor.from_artifact(
        args, os.path.join(export_dir, "global.fmtpu"), device=dev)
    out = {"width": "d 512, 4 layers (the FedLLM main path), wider than "
                    "bench_llm_serving_adapter_churn's d 128"}
    try:
        pred.generate("warm", max_new_tokens=2, adapter=names[0])
        serve_sweep(pred, SERVE_PROMPTS, conc, names, max_new)   # warm
        out["no_churn"], _ = serve_sweep(pred, SERVE_PROMPTS, conc, names,
                                         max_new)
        legs, new = [], {}
        for r in range(rounds):
            victim = names[r % len(names)]
            new[victim] = rand_adapter()
            # past the filesystem's mtime tick since the last export
            time.sleep(CHURN["poll_s"])
            with cf.ThreadPoolExecutor(1) as exporter:
                fut = exporter.submit(save_adapter_artifacts,
                                      {victim: new[victim]}, watched)
                leg, _ = serve_sweep(pred, SERVE_PROMPTS, conc, names,
                                     max_new)
                fut.result(timeout=60)
            legs.append(leg)
        bank = pred.adapter_bank
        deadline = time.time() + 10        # let the last swap land
        while bank.swaps < rounds and time.time() < deadline:
            time.sleep(0.05)
        health = pred.engine.health()
        out["churn"] = {
            "tokens_per_s": sum(x["tokens_per_s"] for x in legs) / rounds,
            "tokens_per_s_best": max(x["tokens_per_s"] for x in legs),
            "p99_latency_s": max(x["p99_latency_s"] for x in legs),
            "rounds": [x["tokens_per_s"] for x in legs],
            "swaps": bank.swaps, "health": health["status"]}
        require(bank.swaps == rounds, f"churn: the watcher applied "
                                      f"{bank.swaps} swaps, expected {rounds}")
        require(health["status"] == "ok", f"churn: engine {health}")
        fresh_bank = AdapterBank(adapter, alpha=bundle.lora_alpha,
                                 capacity=capacity)
        fresh_bank.add(victim, new[victim])
        fresh = CausalLMPredictor(
            bundle, adapter, tokenizer=tok, mode="batch",
            batch_opts=dict(SERVE_BATCH, max_adapters=capacity),
            adapter_bank=fresh_bank, device=dev)
        try:
            require(greedy_texts(pred, victim) == greedy_texts(fresh, victim),
                    f"churn: {victim}'s tokens after its swap differ from a "
                    f"fresh predictor's with the new version")
        finally:
            fresh.close()
    finally:
        pred.close()
    return out


def main() -> int:
    import tempfile

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    try:
        import fedml_tpu_torch as fedml
        from fedml_tpu_torch import llm
        from fedml_tpu_torch.arguments import Arguments
        from fedml_tpu_torch.core.kernels import build
        from fedml_tpu_torch.core.kernels import conv_block as cb
        from fedml_tpu_torch.core.kernels import flash_attention as fa
        from fedml_tpu_torch.llm import attention as attn
    except ImportError as e:
        print(f"chip_smoke: the fedml_tpu_torch package is missing ({e}); "
              f"run from the root of a checkout", file=sys.stderr)
        return 1
    import torch.nn.functional as F
    # cuDNN runs f32 convolutions in TF32 by default; the f32 reference
    # must be full f32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        return run(torch, F, fedml, llm, Arguments, build, cb, fa, attn,
                   tmp)


def run(torch, F, fedml, llm, Arguments, build, cb, fa, attn, tmp) -> int:
    """The phases after the imports; ``tmp`` holds checkpoints, artifacts
    and exports and is removed afterwards."""
    card = card_line()
    print(f"card: {card}", flush=True)
    spilled = build_all(build, ["conv_block", "flash_attention"])
    mma = {fn: n for fn, n in spilled.items() if "_mma_kernel" in fn}
    n_attn = sum("flash_" in fn for fn in mma)
    n_conv = sum("conv_block_mma_kernel" in fn for fn in mma)
    require(n_attn == 12 and n_conv == len(cb.MMA_WIDTHS) ** 2,
            f"expected 12 tensor-core instantiations of attention (B2, B3, "
            f"B4 x 4 head widths) and {len(cb.MMA_WIDTHS) ** 2} of B1 (cin x "
            f"cout), the compiler reported {mma}")
    require(not any(mma.values()), f"tensor-core kernels spill: {mma}")
    simt_bf16 = [fn for fn in spilled if "bfloat16" in fn and any(
        k in fn for k in ("conv_block_kernel", "flash_fwd_kernel",
                          "flash_dq_kernel", "flash_dkv_kernel"))]
    require(not simt_bf16, f"bf16 CUDA-core B1-B4 built: {simt_bf16}")

    gen = torch.Generator().manual_seed(0)
    main_err, main_err16 = 0.0, 0.0
    for dtype in ("float32", "bfloat16"):
        shapes = [(BATCH, h, h, cin, cout, s)
                  for (h, cin, cout, s), _ in FLAGSHIP] + ODD
        for shape in shapes:
            err, gerr, err16 = check_case(torch, cb, gen, shape, dtype)
            if dtype == MAIN_PATH["precision"] and shape[0] == BATCH:
                main_err = max(main_err, err)
                main_err16 = max(main_err16, err16)
            vs16 = "" if err16 is None else f" (plain bf16: {err16:.3e})"
            print(f"check {dtype:8s} n,h,w,cin,cout,s={shape}: max abs err "
                  f"{err:.3e}{vs16}, grad rel err {gerr:.3e}", flush=True)
    attn_err = {}
    for dtype in ("float32", "bfloat16"):
        for shape in ATTN_SHAPES:
            errs = check_attention(torch, fa, attn, gen, shape, dtype)
            if shape == ATTN_MAIN and dtype == "bfloat16":
                attn_err = dict(zip(("flash_fwd", "flash_dq", "flash_dkv"),
                                    errs))
            print(f"check {dtype:8s} attention b,s,h,d,mask={shape}: max abs "
                  f"err O {errs[0]:.3e}, dQ {errs[1]:.3e}, dK/dV "
                  f"{errs[2]:.3e}", flush=True)

    rows = time_geometries(torch, F, cb, gen, MAIN_PATH["precision"])
    for r in rows:
        print(f"time bf16 bs{BATCH} {r['geometry']} x{r['count']} (cluster "
              f"{r['cluster']}): kernel "
              f"{r['ms']:.4f} ms (device time {r['device_ms']:.4f} ms), "
              f"plain {r['plain_ms']:.4f} ms, cuDNN chain device time "
              f"{r['library_ms']:.4f} ms (events {r['library_event_ms']:.4f}"
              f" ms), bound {r['bound_ms']:.5f} ms ({r['bound_by']})",
              flush=True)
    per_fwd = {k: sum(r[k] * r["count"] for r in rows)
               for k in ("ms", "device_ms", "plain_ms", "library_ms",
                         "library_event_ms", "bytes_ms", "ops_ms")}
    # the 27 launches together: their bytes over the memory rate against
    # their operations over the peak
    per_fwd["bound_ms"] = max(per_fwd["bytes_ms"], per_fwd["ops_ms"])
    per_fwd["bound_by"] = ("bytes" if per_fwd["bytes_ms"] >= per_fwd["ops_ms"]
                           else "operations")
    print(f"time per ResNet-56 forward (27 blocks, bs{BATCH}, bf16): "
          f"kernel {per_fwd['ms']:.3f} ms (device time "
          f"{per_fwd['device_ms']:.3f} ms), plain {per_fwd['plain_ms']:.3f} "
          f"ms, cuDNN chain device time {per_fwd['library_ms']:.3f} ms "
          f"(events {per_fwd['library_event_ms']:.3f} ms), bound "
          f"{per_fwd['bound_ms']:.4f} ms ({per_fwd['bound_by']})", flush=True)
    attn_time = {}
    for label, shape in (("main", ATTN_MAIN), ("hot", ATTN_HOT)):
        attn_time[label] = time_attention(torch, F, fa, gen, shape,
                                          "bfloat16")
        for kernel, r in attn_time[label].items():
            print(f"time bf16 attention {kernel:3s} b,s,h,d={shape[:4]}: "
                  f"kernel {r['ms']:.4f} ms (device time {r['device_ms']:.4f}"
                  f" ms), plain {r['plain_ms']:.4f} ms, SDPA device time {r['library_ms']:.4f} ms"
                  f"{' (fwd)' if kernel == 'fwd' else ' (bwd: dQ+dK+dV)'}, "
                  f"bound {r['bound_ms']:.5f} ms ({r['bound_by']})",
                  flush=True)

    worst, acc_gpu, acc_cpu = tiny_run_agreement(torch, fedml)
    print(f"tiny run (resnet20, f32): card vs CPU params within "
          f"{worst:.3f} of tolerance; test acc {acc_gpu} vs {acc_cpu}",
          flush=True)
    worst, loss_gpu, loss_cpu = tiny_llm_agreement(
        torch, llm.run_federated_llm, Arguments)
    print(f"tiny run (LoRA causal LM, f32, flash): card vs CPU adapters "
          f"within {worst:.3f} of tolerance; test loss {loss_gpu:.6f} vs "
          f"{loss_cpu:.6f}", flush=True)
    for dtype, (worst, replays) in captured_vs_eager(torch).items():
        print(f"captured step vs eager loop (resnet20, {dtype}, 4 clients, "
              f"{replays} replays, 1 capture): within {worst:.3f} of "
              f"tolerance {CAPTURE_TOL[dtype]}", flush=True)
    worst, blocks = resume_parity(torch, tmp)
    print(f"resume (resnet20, f32, 4 rounds, checkpoint every 2, "
          f"{blocks} blocks): 2 rounds resumed to 4 vs uninterrupted, "
          f"largest param difference {worst:.3e}", flush=True)

    record, resnet_launches = flagship(torch, cb, fa, card, tmp)
    h = record["handoff"]
    print(f"flagship hand-off ({card}): checkpoint {h['checkpoint_bytes']} "
          f"bytes, maybe_save {h['maybe_save_s']:.4f} s, flush "
          f"{h['flush_s']:.4f} s; artifact {h['artifact_bytes']} bytes in "
          f"{h['save_model_s']:.4f} s; CheckpointPredictor on "
          f"{h['predict_images']} test images: max abs err "
          f"{h['predict_max_abs_err']:.1e} vs the eval forward, "
          f"{h['predict_b1_launches']} B1 launches", flush=True)
    print(f"flagship: capture {record['capture_s']:.2f} s (apart from the "
          f"rounds), {record['block_s']:.2f} s for {FLAGSHIP_BLOCK} rounds "
          f"of 64 clients = {record['step_time_s']:.3f} s per round, "
          f"{record['ms_per_local_step']:.2f} ms per local step, MFU "
          f"{record['mfu']}, SP baseline {record['sp_baseline_round_s']:.2f}"
          f" s per round; B1 {record['b1_launches']} launches = "
          f"{record['b1_per_forward']:.0f} per forward; card after the "
          f"block (SM clock, power, temperature): "
          f"{record['card_after_block']}", flush=True)
    print(json.dumps({"flagship": record}), flush=True)

    t_family = time.perf_counter()
    for label, (diff, moved, caps) in family_agreement(torch, fedml).items():
        print(f"family {label:15s} (resnet20, f32, 2 rounds, 4 of 8 "
              f"clients): GPU engine vs SP loop largest difference "
              f"{diff:.3e} (largest update {moved:.3e}, bound "
              f"{FAMILY_ULPS} ulps), {caps} capture(s)", flush=True)
    family_s = time.perf_counter() - t_family
    scaffold, scaffold_launches = scaffold_flagship(torch, cb, fa)
    print(f"SCAFFOLD flagship ({card}): {scaffold['rounds_per_hour']:.2f} "
          f"rounds/hour ({scaffold['step_time_s']:.3f} s per round, "
          f"{scaffold['ms_per_local_step']:.2f} ms per local step) beside "
          f"FedAvg's {record['value']:.2f} ({record['step_time_s']:.3f} s) "
          f"above; capture {scaffold['capture_s']:.2f} s, "
          f"{scaffold['replays']} replays, B1 {scaffold['b1_launches']} "
          f"launches = {scaffold['b1_per_forward']:.0f} per forward; "
          f"client-state stack [64, ...] {scaffold['client_state_bytes']} "
          f"bytes; card after the block: {scaffold['card_after_block']}",
          flush=True)
    fold = fedsgd_fold(torch, cb, fa, gen)
    for key in ("fold", "unfold"):
        r = fold[key]
        print(f"FedSGD {key:6s} ({card}): one round {r['round_s']:.3f} s "
              f"({r['passes']} passes at batch {r['batch']}, capture "
              f"{r['capture_s']:.2f} s apart), B1 {r['b1_launches']} "
              f"launches", flush=True)
    print(f"FedSGD folded vs unfolded aggregate: largest difference "
          f"{fold['max_abs_diff']:.3e} = {fold['rel_diff']:.2e} of the "
          f"largest entry (bound {FOLD_TOL:.2e})", flush=True)
    print(json.dumps({"optimizers": {
        "phase_s": time.perf_counter() - t_family,
        "family_agreement_s": family_s, "scaffold": scaffold,
        "fedsgd": fold, "card": card}}), flush=True)

    t_robust = time.perf_counter()
    agreement = robust_agreement(torch)
    for label, r in agreement.items():
        extra = "" if "fused_vs_host" not in r else (
            f"fused vs host {r['fused_vs_host']:.3e} (verdicts "
            f"{r['verdict_diff']:.1e}), ")
        extra += "" if "engine_vs_sp" not in r else (
            f"engine vs SP loop {r['engine_vs_sp']:.3e}, ")
        print(f"robust {label:20s} (resnet20, f32, 2 rounds, 4 of 8 "
              f"clients): {extra}largest update {r['largest_update']:.3e}, "
              f"{r['captures']} capture(s)", flush=True)
    normal = device_normal_check(torch)
    print(f"device normal ({card}): {normal['draws']} draws within "
          f"{normal['max_ulps']} ulp of the host form, "
          f"{normal['device_ms']:.3f} ms on the card", flush=True)
    agreement_s = time.perf_counter() - t_robust
    defended, robust_launches = robust_flagship(torch, cb, fa)
    for leg, r in defended.items():
        print(f"defended flagship {leg:5s} ({card}): "
              f"{r['rounds_per_hour']:.2f} rounds/hour "
              f"({r['step_time_s']:.3f} s per round over {r['rounds']}) "
              f"beside FedAvg's {record['value']:.2f}; attack + defense + "
              f"DP {r['defense_ms_per_round']:.2f} ms of device time per "
              f"round (server side {r['server_ms_per_round']:.2f}, clients' "
              f"DP {r['client_dp_ms_per_round']:.2f}); matrix "
              f"{r['matrix_bytes']} bytes; verdicts keep {r['verdict_kept']}"
              f"; B1 {r['b1_launches']} launches = "
              f"{r['b1_per_forward']:.0f} per forward, {r['captures']} "
              f"capture; capture {r['capture_s']:.2f} s apart; HBM peak "
              f"{r['hbm_peak_gb']:.2f} GB", flush=True)
    benches = robust_bench(torch)
    for metric, r in benches.items():
        print(f"{metric} ({card}): fused {r['value']:.1f} rounds/hour, host "
              f"{r['host_path_rounds_per_hour']:.1f}, vs_baseline "
              f"{r['vs_baseline']:.3f}, params_max_abs_diff "
              f"{r['params_max_abs_diff']:.1e}, verdicts identical "
              f"{r['verdicts_identical']}", flush=True)
    print(json.dumps({"robust": {
        "phase_s": time.perf_counter() - t_robust,
        "agreement_s": agreement_s, "agreement": agreement,
        "device_normal": normal, "flagship": defended,
        "fedavg_rounds_per_hour": record["value"], "benches": benches,
        "card": card}}), flush=True)

    t_faults = time.perf_counter()
    faults = faults_agreement(torch)
    for label, r in faults.items():
        print(f"faults {label:24s} (resnet20, f32): {json.dumps(r)}",
              flush=True)
    faults_agreement_s = time.perf_counter() - t_faults
    faults_legs, faults_launches = faults_flagship(torch, cb, fa)
    base = faults_legs["fedavg"]
    for leg, r in faults_legs.items():
        extra = "" if "loo_s" not in r else (
            f"; LOO {r['loo_s']:.2f} s, {r['evaluations']} evaluations, "
            f"matrix {r['matrix_bytes']} bytes, cohort pinned at "
            f"{r['sample_cap']}")
        print(f"faults flagship {leg:14s} ({card}): "
              f"{r['rounds_per_hour']:.2f} rounds/hour ({r['step_time_s']:.3f}"
              f" s per round over {r['rounds']}, {r['ms_per_local_step']:.2f}"
              f" ms per local step) beside FedAvg's "
              f"{base['rounds_per_hour']:.2f} at 64 of 128; cohorts "
              f"{r['cohorts']}, dropped {r['dropped']}, stragglers "
              f"{r['stragglers']}, work {r['work_sum']}; B1 "
              f"{r['b1_launches']} launches = {r['b1_per_forward']:.0f} per "
              f"forward, {r['captures']} capture{extra}", flush=True)
    print(json.dumps({"chaos_selection": {
        "phase_s": time.perf_counter() - t_faults,
        "agreement_s": faults_agreement_s, "agreement": faults,
        "legs": faults_legs, "flagship_rounds_per_hour": record["value"],
        "card": card}}), flush=True)

    t_async = time.perf_counter()
    agreement = async_agreement(torch)
    for label, r in agreement.items():
        print(f"async {label:20s} (resnet20, f32): {json.dumps(r)}",
              flush=True)
    async_agreement_s = time.perf_counter() - t_async
    async_legs, async_launches = async_flagship(torch, cb, fa)
    # sync FedAvg at 64 of 128 (phase 9's leg 0): 64 updates a round
    sync_updates = 64 * base["rounds_per_hour"]
    for leg, r in async_legs.items():
        extra = "" if "defense_ms_per_pour" not in r else (
            f"; re-base + attack + defense {r['defense_ms_per_pour']:.2f} "
            f"ms of device time per pour, [K, D] {r['matrix_bytes']} bytes,"
            f" ring {r['ring_bytes']} bytes ({r['ring_slots']} slots), "
            f"byzantine rows poured {r['byzantine_poured']}, all excluded "
            f"{r['byzantine_excluded']}")
        print(f"async flagship {leg:10s} ({card}): {r['s_per_pour']:.3f} s "
              f"per pour over {r['pours']} ({r['pours_per_hour']:.2f} "
              f"pours/hour, {r['updates_per_wall_hour']:.1f} updates per "
              f"wall hour beside sync FedAvg's {sync_updates:.1f} at 64 of "
              f"128), {r['updates_per_sim_hour']:.1f} updates per simulated"
              f" hour, staleness mean {r['staleness_mean']:.2f} max "
              f"{r['staleness_max']}; capture {r['capture_s']:.2f} s and "
              f"bootstrap {r['bootstrap_s']:.2f} s ({r['bootstrap_steps']} "
              f"steps) apart; {r['timed_steps']} timed steps "
              f"({r['ms_per_local_step']:.2f} ms each), dispatched "
              f"{r['dispatched']}, dropped {r['dropped']}, stragglers "
              f"{r['stragglers']}; B1 {r['b1_launches']} launches = "
              f"{r['b1_per_forward']:.0f} per forward, {r['captures']} "
              f"capture{extra}", flush=True)
    print(json.dumps({"async": {
        "phase_s": time.perf_counter() - t_async,
        "agreement_s": async_agreement_s, "agreement": agreement,
        "legs": async_legs, "sync_fedavg_updates_per_wall_hour": sync_updates,
        "card": card}}), flush=True)

    export_dir = os.path.join(tmp, "adapters")
    reset_launches(cb, fa)
    t0 = time.time()
    result = llm.run_federated_llm(Arguments(
        **LLM_MAIN_PATH, llm_adapter_export_dir=export_dir))
    torch.cuda.synchronize()
    wall = time.time() - t0
    llm_launches = launches(cb, fa)
    hist = result["history"]
    for h in hist:
        print(f"FedLLM round {h['round']}: "
              f"{h['local_steps']} local steps, {h['eval_batches']} eval "
              f"batches, train_loss {h['train_loss']:.4f}, test_loss "
              f"{h['test_loss']:.4f}, test_acc {h['test_acc']:.4f}",
              flush=True)
        require(all(math.isfinite(h[k]) for k in (
            "train_loss", "train_acc", "test_acc", "test_loss")),
            f"FedLLM round {h['round']}: non-finite metrics")
    require(all(torch.isfinite(v).all().item()
                for v in result["params"].values()), "non-finite adapters")
    layers = LLM_MAIN_PATH["llm_num_layers"]
    stats = result["dispatch_stats"]
    require(stats["captures"] == 1, f"FedLLM: {stats['captures']} captures")
    # the captured step's replays plus the warm-up's eager steps
    steps = sum(h["local_steps"] for h in hist)
    require(stats["replays"] == steps, f"FedLLM: {stats['replays']} "
                                       f"replays for {steps} local steps")
    steps += stats["warmup_steps"]
    # the export's eager personalisation steps, per silo
    personal = (Arguments().llm_adapter_personalize_steps
                * LLM_MAIN_PATH["client_num_in_total"])
    steps += personal
    evals = sum(h["eval_batches"] for h in hist)
    want = {"conv_block": 0, "flash_fwd": layers * (steps + evals),
            "flash_dq": layers * steps, "flash_dkv": layers * steps}
    require(llm_launches == want, f"FedLLM launches {llm_launches}, "
                                  f"expected {want}")
    export = export_check(torch, result, export_dir)
    print(f"FedLLM main path: {wall:.1f} s end to end, {wall / len(hist):.2f} "
          f"s per round (eval, the step's capture, "
          f"{stats['capture_s']:.2f} s, and the export included), {steps} "
          f"local steps ({stats['warmup_steps']} of them the capture's "
          f"warm-up, {personal} the export's personalisation) and {evals} "
          f"eval batches; launches {llm_launches}", flush=True)
    print(f"FedLLM export ({card}): {export['adapters']} adapters, "
          f"{export['bytes']} bytes ({export['bytes_per_adapter']} per "
          f"adapter, {export['lora_params']} LoRA params) in "
          f"{export['wall_s']:.3f} s, personalisation included", flush=True)

    # the serving path, on the adapter the FedLLM run just trained
    from fedml_tpu_torch.llm import kv_cache as kvc
    from fedml_tpu_torch.serving.batch import AdapterBank, DecodeScheduler
    from fedml_tpu_torch.serving.llm_template import CausalLMPredictor
    checks = {"cache_arithmetic_slots": cache_arithmetic(torch, kvc)}
    tiny = dict(dataset="llm_synth", model="causal_lm", random_seed=3,
                llm_hidden_size=32, llm_num_layers=2, llm_num_heads=2,
                llm_intermediate_size=64, llm_max_seq_len=64, lora_rank=0,
                llm_attention_impl="dense")
    checks["decode_vs_forward_f32_tiny"] = decode_vs_forward(
        torch, llm.build_llm_bundle, Arguments, DecodeScheduler,
        AdapterBank, tiny, None, "float32")
    checks["decode_vs_forward_bf16"] = decode_vs_forward(
        torch, llm.build_llm_bundle, Arguments, DecodeScheduler,
        AdapterBank, LLM_MAIN_PATH, result["params"], "bfloat16")
    checks["greedy_parity_parted"] = greedy_parity(
        torch, llm.build_llm_bundle, Arguments, CausalLMPredictor)
    print(f"serving checks: {json.dumps(checks)}", flush=True)
    t0 = time.time()
    serving, serve_launches = serving_phase(torch, llm, cb, fa, Arguments,
                                            result["adapter_export"])
    serving["checks"] = checks
    serving["wall_s"] = time.time() - t0
    for leg, r in serving["legs"].items():
        print(f"serving {leg}: {r['tokens_per_s']:.1f} tokens/s, p99 "
              f"{r['p99_latency_s']:.3f} s ({r['tokens']} tokens in "
              f"{r['wall_s']:.2f} s)", flush=True)
    churn = serving["churn"]
    print(f"serving churn ({card}, {churn['width']}): churn-free "
          f"{churn['no_churn']['tokens_per_s']:.1f} tokens/s p99 "
          f"{churn['no_churn']['p99_latency_s']:.3f} s; under churn "
          f"{churn['churn']['tokens_per_s']:.1f} tokens/s (best "
          f"{churn['churn']['tokens_per_s_best']:.1f}) p99 "
          f"{churn['churn']['p99_latency_s']:.3f} s; "
          f"{churn['churn']['swaps']} swaps, engine "
          f"{churn['churn']['health']}; from_artifact load "
          f"{serving['from_artifact_load_s']:.2f} s", flush=True)
    print(json.dumps({"serving": serving}), flush=True)

    ms, losses, hot_launches, n_params, hot_params = hot_loop(
        torch, llm, cb, fa)
    require(all(math.isfinite(x) for x in losses), "hot loop: non-finite loss")
    per = HOT_LOOP["num_layers"] * HOT_STEPS
    require(hot_launches == {"conv_block": 0, "flash_fwd": per,
                             "flash_dq": per, "flash_dkv": per},
            f"hot loop launches {hot_launches}, expected {per} of each "
            f"attention kernel")
    print(f"hot loop ({n_params / 1e6:.1f}M params, bs{HOT_BATCH} x seq "
          f"{HOT_LOOP['max_seq_len']}, bf16, flash): {ms:.2f} ms per SGD "
          f"step, losses {[round(x, 4) for x in losses]}; launches "
          f"{hot_launches}", flush=True)
    codec = codec_speed(torch, hot_params, tmp)
    del hot_params
    print(f"codec ({card}): save_model {codec['bytes']} bytes of the hot "
          f"loop's params in {codec['save_s']:.3f} s "
          f"({codec['save_mb_per_s']:.0f} MB/s), load_model in "
          f"{codec['load_s']:.3f} s ({codec['load_mb_per_s']:.0f} MB/s), "
          f"round trip bitwise", flush=True)
    print(json.dumps({"codec": codec}), flush=True)

    # round-shape fields, then the hot loop's shape (B2-B4 only)
    kernels = [{
        "name": "conv_block", "route": "cuda",
        "source": "fedml_tpu_torch/core/kernels/csrc/conv_block.cu",
        "replaces": "fedml_tpu/core/kernels/conv_block.py:144",
        "design": DESIGN["conv_block"],
        "launches": resnet_launches["conv_block"],
        "launches_scaffold": scaffold_launches["conv_block"],
        "launches_defended_flagship": robust_launches["conv_block"],
        "launches_chaos_selection": faults_launches["conv_block"],
        "launches_async": async_launches["async"]["conv_block"],
        "launches_async_defended": async_launches["async_krum"]["conv_block"],
        "launches_fedsgd_fold": fold["fold"]["b1_launches"],
        "launches_fedsgd_unfold": fold["unfold"]["b1_launches"],
        "max_abs_err_fold_batch": fold["b1_fold_batch_max_abs_err"],
        "launches_serving": serve_launches["conv_block"],
        "max_abs_err": main_err,
        "max_abs_err_plain_bf16": main_err16,
        "ms": per_fwd["ms"], "plain_ms": per_fwd["plain_ms"],
        "bound_ms": per_fwd["bound_ms"], "bound_by": per_fwd["bound_by"],
        "library_ms": per_fwd["library_ms"],
        "device_ms": per_fwd["device_ms"],
        "clusters": {r["geometry"]: r["cluster"] for r in rows},
        "ms_hot": None, "device_ms_hot": None, "plain_ms_hot": None,
        "library_ms_hot": None, "bound_ms_hot": None,
        "bound_by_hot": None}]
    for name, key, line in (("flash_fwd", "fwd", 121), ("flash_dq", "dq", 176),
                            ("flash_dkv", "dkv", 213)):
        r, rh = attn_time["main"][key], attn_time["hot"][key]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "fedml_tpu_torch/core/kernels/csrc/flash_attention.cu",
            "replaces": f"fedml_tpu/llm/attention.py:{line}",
            "design": DESIGN[name],
            "launches": llm_launches[name],
            "launches_serving": serve_launches[name],
            "max_abs_err": attn_err[name],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "device_ms": r["device_ms"],
            "ms_hot": rh["ms"], "device_ms_hot": rh["device_ms"],
            "plain_ms_hot": rh["plain_ms"],
            "library_ms_hot": rh["library_ms"],
            "bound_ms_hot": rh["bound_ms"], "bound_by_hot": rh["bound_by"]})
    print(json.dumps({"kernels": kernels}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    os.chdir(os.path.dirname(os.path.abspath(__file__)))
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        sys.exit(1)
