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
   B1 (fused conv block) at every ResNet-56 block geometry (batch 32), the
   odd shapes of its parity tests and ResNet-18's stage 0 (32x32x64,
   cluster 8, bf16; float32 there must be refused); B2-B4 (flash attention forward, dQ,
   dK/dV) at the FedLLM round's shape, the 111M hot loop's, long context
   and the odd shapes of ``tests/test_llm.py`` (key-padding masks, rows
   with no live key, d 8/100/128 with ragged s); float32 and bfloat16,
   gradients included, and the autograd Function against dense attention;
4. time each kernel at the main paths' shapes (B1 at ResNet-56's and
   ResNet-18's, B2-B4 at the FedLLM round's and the hot loop's): the kernel with CUDA events around eager
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
   one block of 1 round (2 until phases 20 and 21 took the time) through
   ``run_rounds_fused`` in timing mode and
   one eval; the round's FLOPs and MFU; the SP golden loop for one round
   on 4 clients as the baseline (per sample); a ``{"flagship": ...}`` line. B1 held to
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
   timed block of 1 round, one eval), rounds/hour beside phase 6's
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
   multi-krum keeping 20, one timed round on each of the fused path,
   the host path and LDP (the fused block cut from 2 rounds to 1 to pay
   for phase 18); rounds/hour beside phase
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
   1 round each, leg 2 leg 1 with LOO for 1 round (the fused robust path
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
   1 timed pour (4 until phase 18 and 2 until phases 20 and 21 needed
   the time), leg 2 with ``bench_async_robust``'s attack (26 of 128
   byzantine_random x10) and krum, the bootstrap then 1 timed pour:
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
13. serving chaos and the fleet (``serving/autoscale.py``, the batch
   engine's ``chaos=``): (a) checks, f32 with TF32 off: the tiny LM's
   greedy tokens under a NaN at decode step 2 and a stall at step 4 equal
   the chaos-free run on the card and the CPU's (two resets); two
   subprocess replicas of phase 11's exported adapter on the card behind
   the gateway, the first crashing at its request 3: every request
   answered with an in-process predictor's tokens, the crashed process
   replaced by ``health_check``; (b) ``bench_llm_serving_chaos``'s
   traffic and plan (c8, 24 requests, stall + NaN, watchdog 0.3 s) with
   recovery on and off, plus a chaos-free leg: goodput, success rate,
   faults, resets, trips; (c) ``bench_llm_serving_fleet``'s soak (3
   in-process replicas + 1 burst, 48 multi-turn requests at c256 (the
   bench's 768 cut in depth), 4 % connection drops, the last replica lost
   after 40 %), fleet_off then
   fleet_on: tokens/s, TTFT, success before and after the loss, suffix
   and prefix hits, scale events, routes; both on the FedLLM main path's
   model; a ``{"fleet": ...}`` line. B1-B4 launch 0 times in the phase;
14. the LLM hot loop: 4 SGD steps of the 111M causal LM (bs 8 x seq 1024,
   bf16, full parameters), 8 launches of each attention kernel per step;
   then ``save_model`` / ``load_model`` of its params (the codec's MB/s,
   round trip bitwise);
15. the model zoo and tasks: (a) on the card against the CPU (f32, TF32
    off): CNNFemnist's dropout masks bit for bit and a 2-round run with
    dropout, the Shakespeare LSTM under FedOpt (and its captured step
    against the eager loop at full width), the multilabel and regression
    tasks, a digits run; (b) ``bench_engine_mfu_resnet18`` at full width
    (ResNet-18, synthetic CIFAR-10 50,000, 64 clients, bf16, batch 32; the
    capture, one block of 2 rounds, one eval), as written (cuDNN) and with
    the fused block (B1 at 2 launches per forward, counted through the
    graph's replays, one capture): rounds/hour, FLOPs, MFU, the data's and
    the model's bytes, ``vs_baseline`` against one SP round on 8 clients;
    (c) ``bench_shakespeare_fedopt`` and (d) ``bench_time_to_acc`` as
    written, on the bundled real text and digits: rounds/hour, accuracy,
    rounds (and seconds) to the target; a ``{"zoo": ...}`` line;
16. the cross-silo runtime: (a) checks (f32, TF32 off): the 4-silo LR
    session of ``tests/test_cross_silo.py`` (3 rounds, INPROC) on the card
    against the CPU, the same session over TCP on loopback bitwise equal
    to INPROC, a session under seeded link loss,
    duplication and delay (completes; non-empty link ledger) and its
    JSONL records through ``core/obs/schema.py``; (b)
    ``bench_cross_silo_wire`` as written (digits, LR, 10 silos, 40
    rounds in-proc, dense against ``topk_qsgd`` 5 % + EF with the
    compressed broadcast): model-bearing bytes per round, accuracy,
    rounds to 90 %, wall seconds, its gossip leg (phase 18 (c)) and its
    SecAgg leg (bench.py's, from the bench's own LR init: 4-bit lanes
    against the dense field, bytes, rounds to 90 %, the masked sums equal
    to the plain ones); (c) the flagship's configuration as
    a session over TCP
    (ResNet-56, synthetic CIFAR-10 25,000 / 1,000, bf16, fused block; 4
    silo subprocesses on the card, the server through
    ``run_cross_silo_server`` in this process): 1 untimed round (the
    captures) and 1 timed round, seconds per round, rounds/hour, the
    wait / aggregate / broadcast / eval split, model bytes per round,
    accuracy, and per silo its steps, ms per local step, captures (1) and
    B1 launches, held to 27 x (warm-up + replays); the server's B1 held
    to 27 per eval forward; a ``{"cross_silo": ...}`` line;
17. the buffered-async cross-silo runtime and the other transports: (a)
    checks (f32, TF32 off): a scripted upload trace (fresh, 1-5 versions
    stale, past the base ring, a compressed uplink; undefended, and krum
    with a byzantine row) through ``AsyncFedMLAggregator`` on the card
    against the CPU; phase 16's LR session over PUBSUB_STORAGE (broker in
    this process, payloads through the object store) and over TRPC (a
    process per rank) bitwise equal to INPROC; the LR session as an async
    session (K 2) under link faults (every pour, a balanced buffer
    ledger, staleness >= 1); (b) the flagship's configuration as a
    buffered-async session (K 2 of 4 ResNet-56 silo processes, the server
    and the broker in this process, PUBSUB_STORAGE): 2 untimed pours (the
    captures), 1 timed (2 until phase 22): seconds per pour, updates per wall hour beside
    phase 16 (c)'s, the wait / aggregate / eval / broadcast split, the
    staleness histogram, the store's objects and bytes, per silo its
    trainings, ms per local step, captures (1) and B1 launches held to 27
    x (warm-up + replays); the server's B1 held to 27 per eval forward; an
    ``{"async_cross_silo": ...}`` line;
18. the other cross-silo scenarios: (a) checks (f32, TF32 off): the
    4-node LR gossip session (INPROC) on the card against the CPU, dense
    and with ``topk_qsgd`` (every compressed blob's kept indices and
    levels bit for bit), the SP decentralized loop card against CPU, the
    split-learning and vertical-FL sessions against their SP simulators
    and the CPU, the hierarchical session (1-rank silos) bitwise equal to
    the horizontal one; (b) gossip at the flagship's width (ResNet-56,
    bf16, fused block, 4 node processes over TCP on a ring): 1 untimed
    round (the captures), 1 timed: seconds per round, rounds/hour, per
    node its steps, ms per local step, send, wait, decode and mix
    seconds, captures (1)
    and B1 launches held to 27 x (warm-up + replays), node 0's eval
    launches held to 27 per eval forward, N2N bytes per round, the
    consensus distance and the average model's accuracy; (c) bench.py's
    gossip wire leg (in phase 16 (b)); a ``{"gossip": ...}`` line;
19. secure aggregation: (a) the field math of ``core/mpc`` on the card
    against the CPU and an integer reference, bitwise; (b) the SA and
    LSA sessions (``run_secagg_inproc``, ``run_lsa_inproc``) at the
    flagship's width (ResNet-56, bf16, fused block, 4 silo threads, 1
    round, each silo cut to 2 steps): B1 held to 27 x (warm-up + replays
    + eval batches), the model held to plain FedAvg of the silos'
    deltas within the house tolerance plus one quantum per silo; (c)
    over those deltas, the masking algebra with 0 and 1 silo dropped and
    LightSecAgg's coding, bitwise; (d) the LR sessions, card vs CPU; a
    ``{"secure_aggregation": ...}`` line;
20. the compute plane (``core/obs/roofline.py``): (a) the flagship's step
    (ResNet-56, batch 32, bf16, B1; 2 of its 64 clients, 1 round) through
    the GPU engine's seam under ``obs_roofline``: one schema-valid
    ``roofline`` record whose rows carry the round's steps as ``mult``,
    its 27 B1 rows per forward each equal to ``core/kernels/cost.py``'s
    ``block_cost`` for its geometry, the conv + matmul FLOPs equal to
    ``FlopCounterMode``'s of the same step; its predicted ms per step
    beside the step's graph replays timed with CUDA events, predicted MFU
    and memory-bound share; (b) the 111M hot loop's SGD step (8 rows each
    of B2, B3, B4 equal to ``attention_cost``, none of their launches
    counted as the program's) and the serving decode and prefill programs
    through ``DecodeScheduler(roofline=True)`` at 64 slots (one record
    per program and signature, not one per token); (c) the engine at
    batch 16: one ``recompile`` record naming ``['train']['x']``, none
    before it; (d) the always-on signature's cost per dispatch at the
    64-slot decode step; a ``{"roofline": ...}`` line;
21. cross-device (``cross_device/``): (a) ``run_cross_device_inproc``'s
    session at the flagship's width (ResNet-56, synthetic CIFAR-10,
    bf16, B1; 4 device threads on the card, torch engine, each cut to 2
    steps; 1 round, the server on the card): B1 held to 27 x (warm-up +
    replays + eval batches), the model held to a float32 weighted mean of
    the 4 uploads computed apart within the house tolerance, the round's
    wait / aggregate / eval seconds; (b) the same with
    ``device_wire_compression: topk_qsgd`` (ratio 0.1): each upload's
    decode on the card equal to the CPU's bitwise; (c) the LR / digits
    session with one native device and two torch devices, on the card
    and on the CPU: the native device's round-0 artifact the same bytes,
    the global model's on-device accuracy improving; a
    ``{"cross_device": ...}`` line;
22. multi-rank on the one card (``core/mesh.py``, ``core/launch.py``:
    one process per rank, the kernels built before the ranks start, f32
    checks with TF32 off and cuDNN deterministic): (a) the GPU engine's
    client axis at the flagship's width (ResNet-56, bf16, B1, 8 of 8
    clients over 4,096 samples, 1 round): the plain engine here,
    ``mesh_shape={"client": 1}`` in an NCCL group of one rank (bitwise
    the plain engine) and ``{"client": 2}`` on two gloo ranks sharing
    the card (within the house tolerance of one rank, the ranks bitwise
    equal), B1 held to 27 x each rank's forwards, the all-reduce's bytes
    and ms and the bytes staged through the host; (b) ring attention at
    the FedLLM shape on the two ranks (sp 2), f32 and bf16, and
    ``make_ring_forward`` of the FedLLM model, against dense attention
    on the card; (c) the FSDP + tensor-parallel step of the FedLLM model
    (flash, f32) in the NCCL group of one rank, without and with LoRA
    adapters on every target, and with the adapters at ``{"tensor": 2}``
    on the two gloo ranks (each factor's slice in its shard's side path,
    its gradient summed over the ranks), against the unsharded step on
    the card, B2-B4 counted on each rank; (d) defended rounds over the two
    ranks (MULTI_RANK with a ``byzantine_flip`` client and RFA, the
    relayout as f32 and as int8 rows: one ``all_to_all`` into feature
    shards, the sharded defense summing its partials over the ranks)
    against one rank in this process: f32 within the house tolerance,
    int8's defense input on at most RELAYOUT_FLIP_SHARE other levels, the
    verdicts equal, the ranks bitwise equal, B1 27 x forwards, the
    all-to-all's calls, bytes, wire bytes ((g - 1) / g of them), ms and
    staged bytes; (e) buffered-async pours over the two ranks (K 4 of 8
    in flight, the bootstrap and 1 timed pour) against one rank, the same
    cohorts drawn; a ``{"multi_rank": ...}`` line;
23. the long tail of training: (a) every model the slice ported
    (LeNet-5, the finance nets, VGG-11 / 16, MobileNetV3-Small,
    EfficientNet-B0, the GAN pair, SegNet, the FedGKT and FedNAS nets,
    and SimpleCNN on 28x28x1, whose 1-channel stem is now a GEMM)
    on the card against the CPU, f32 with TF32 off: logits and
    gradients (the dropout models in training mode from one key), and
    bf16 MobileNetV3-Small against its f32 self; (b) FedGKT, FedNAS,
    FedSeg and FedGAN at ``tests/test_protocols.py``'s configurations
    (FedGAN's data cut to 512 samples), 2 rounds each, card against CPU:
    params, histories and FedNAS's architecture held to the house
    tolerance after the first round, the second round's drift reported;
    (c) ``bench_hierarchical_femnist``'s configuration
    (MobileNetV3-Small bf16 over hierarchicalfl, 24 FEMNIST-shaped
    clients, 4 groups x 2 edge rounds): s per global round; (d)
    ``turbo_aggregate`` (8 of 64 clients, 2 groups, 1 round) and the
    centralized trainer (128 captured steps, one eval) at the flagship's
    widths with B1: the turbo model against plain FedAvg of the same
    updates to one 2^-16 quantum per client, B1 = 27 x forwards for both;
    a ``{"tail": ...}`` line. (To pay for it, the flagship-width legs of
    phases 7-10 ran MAIN_PATH's widths on 25,000 of its 50,000 samples;
    since phase 22 (d) / (e), on 12,500.)
24. the platform (``api``, ``cli``, ``agents``, ``utils``): PLATFORM_PATH
    (MAIN_PATH's ResNet-56, bf16, B1, cut in depth to 8 of 8 clients over
    2,048 samples, 1 round) written as a yaml: (a) ``collect_env`` names
    the card and ``run_diagnosis`` reports the device (the card's name)
    and TCP OK, gRPC as it comes; (b) ``cli.main(["train", "--cf",
    yaml])`` in this process, its artifact the run's params bitwise, B1
    held to 27 x (warm-up + replays + eval batches) with one capture; (c)
    the same yaml through a broker, a master and an agent in this process
    (bind token set), dispatched by ``launch_job_remote``: the agent runs
    ``python -m fedml_tpu_torch.cli train`` as a subprocess on the card,
    FINISHED, its params bitwise (b)'s;
    (d) ``api.model_serve`` of that artifact on the card: ``/ready``, then
    ``/predict`` of 32 test images bitwise equal to ``CheckpointPredictor``
    called directly, 27 B1 launches per forward; a ``{"platform": ...}``
    line;
25. one JSON line describing each kernel, then the card line, then
    ``{"ok": true, "device": {...}}`` as the last line.

Each main path is driven with every launch count set to 0 just before it
and read just after. Imports nothing of JAX or ``fedml_tpu``.
"""

from __future__ import annotations

import contextlib
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
# ResNet-18's stage 0 (phase 15's model): 2 stride-1 BasicBlocks of 64
# channels at 32x32, at batch 32 a cluster of 8 CTAs per sample and
# 146,944 bytes of shared memory per CTA in bf16. In f32 one CTA would hold
# the whole sample (858,304 bytes): the kernel refuses it.
RESNET18 = [((32, 64, 64, 1), 2)]
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
FLAGSHIP_BLOCK = 1
# The flagship-width legs of phases 7-10 (SCAFFOLD, the defended
# flagship, faults and selection, async) run MAIN_PATH's widths on its
# 50,000 samples cut in depth to these (25,000 to pay for phase 23, 12,500
# for phase 22 (d) / (e)); their rounds/hour are set beside phase 6's
# FedAvg scaled by the sample ratio (a round's steps follow its samples)
FLAGSHIP_LEG_SAMPLES = 12500
# bench_flagship's baseline: the golden loop (SP, eager local steps), one
# round, per-sample normalised; its 8 clients over 6,250 samples cut in
# depth to 4 over 3,125 (the same rate per sample) for phase 22
SP_BASELINE = dict(MAIN_PATH, backend="sp", client_num_in_total=4,
                   client_num_per_round=4, synthetic_size=3125,
                   max_total_samples=3125)
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
    random_seed=3, fused_conv_block="pallas", enable_tracking=False)
FAMILY = {"FedAvg": {}, "FedProx": {}, "FedOpt": {},
          "FedOpt_adam": dict(server_optimizer="adam", server_lr=0.01),
          "FedOpt_adagrad": dict(server_optimizer="adagrad", server_lr=0.01),
          "FedOpt_yogi": dict(server_optimizer="yogi", server_lr=0.01),
          "FedSGD": dict(server_lr=0.1), "FedLocalSGD": {}, "SCAFFOLD": {},
          "FedNova": dict(momentum=0.9), "FedDyn": {}, "Mime": {}}
FAMILY_ULPS = 4
# (b) SCAFFOLD on the flagship's configuration (MAIN_PATH), its step
# captured apart, one timed block of SCAFFOLD_BLOCK rounds, one eval.
# SCAFFOLD_BLOCK was FLAGSHIP_BLOCK (2) until the secure sessions at the
# flagship's width (phase 19 (b)) took its time.
SCAFFOLD_PATH = dict(MAIN_PATH, federated_optimizer="SCAFFOLD",
                     synthetic_size=FLAGSHIP_LEG_SAMPLES)
SCAFFOLD_BLOCK = 1
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
# fused path, the host path and LDP (gaussian, epsilon 10, delta 1e-5,
# clip 1.0) for 1 round each (2 LDP rounds put the phase at 148 s; the
# fused path's block of FLAGSHIP_BLOCK rounds was cut to 1 to pay for
# phase 18).
ROBUST_FLAGSHIP = dict(MAIN_PATH, synthetic_size=FLAGSHIP_LEG_SAMPLES,
                       enable_attack=True,
                       attack_type="byzantine_flip", byzantine_client_num=12,
                       attack_scale=5.0, enable_defense=True,
                       defense_type="multi_krum", krum_param_m=20)
ROBUST_LEGS = (("fused", ROBUST_FLAGSHIP, 1),
               ("host", dict(ROBUST_FLAGSHIP, robust_fused="host"), 1),
               ("ldp", dict(MAIN_PATH, synthetic_size=FLAGSHIP_LEG_SAMPLES,
                            enable_dp=True, dp_type="local_dp",
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
# the flagship's width). Leg 0 FedAvg, one block of FAULTS_BLOCK rounds;
# leg 1 bench_chaos_selection's knobs (20 % dropout, 10 % stragglers at
# half work, seed 7, tolerance on, oort, adaptive over-sampling capped at
# 1.0), one block of FAULTS_BLOCK rounds; leg 2 leg 1 with LOO, 1 round
# (the fused robust path pins the adaptive cohort at 64). FAULTS_BLOCK was
# FLAGSHIP_BLOCK (2) until the secure-aggregation phase (19) took its time.
FAULTS_BLOCK = 1
FAULTS_PATH = dict(MAIN_PATH, client_num_in_total=128,
                   client_num_per_round=64,
                   synthetic_size=FLAGSHIP_LEG_SAMPLES)
FAULTS_KNOBS = dict(chaos_dropout_prob=0.2, chaos_straggler_prob=0.1,
                    chaos_straggler_work=0.5, chaos_seed=7,
                    chaos_tolerance=True, client_selection="oort",
                    selection_adaptive_oversample=True,
                    selection_max_over_sample=1.0)
FAULTS_LEGS = (("fedavg", FAULTS_PATH, FAULTS_BLOCK),
               ("chaos_oort", dict(FAULTS_PATH, **FAULTS_KNOBS),
                FAULTS_BLOCK),
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
# clients), then 1 timed pour. Leg 2: leg 1 plus bench_async_robust's
# attack scaled to 128 clients (byzantine_random x10 on 26, its 20 %) and
# krum; the bootstrap, then 1 timed pour. (2 timed pours each until phases
# 20 and 21 took the time; 4 in leg 1 until phase 18.)
ASYNC_PATH = dict(FAULTS_PATH, round_mode="async_buffered",
                  async_buffer_k=32, **ASYNC_CHAOS)
ASYNC_LEGS = (("async", ASYNC_PATH, 1),
              ("async_krum", dict(ASYNC_PATH, enable_attack=True,
                                  attack_type="byzantine_random",
                                  attack_scale=10.0, byzantine_client_num=26,
                                  enable_defense=True, defense_type="krum"),
               1))

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

# Serving chaos and the fleet (phase 13). (a) checks, f32 with TF32 off:
# the tiny LM of tests/test_torch_serving_chaos.py (d 32, 2 layers, dense,
# a full fine-tune drawn from its seed) under a NaN at decode step 2 and a
# stall at step 4 (watchdog 0.3 s), card against a chaos-free card run and
# the CPU's; two subprocess replicas of phase 11's exported adapter on the
# card, the first crashing at its request 3 (FLEET_CHECK_REQUESTS through
# the gateway, then a health check). (b) bench.py's
# bench_llm_serving_chaos traffic and plan (c8, 24 requests of 12 tokens,
# every second one sampled; stall at step 12 for 5 s, NaN at step 25;
# watchdog 0.3 s; 64 resets against 0) and (c) bench_llm_serving_fleet's
# soak (3 replicas + 1 burst, 48 requests at c256, 4 % connection drops,
# the last replica lost after 40 % of the requests; fleet_off then
# fleet_on; the bench's 32 sessions per tenant cut to 2, its depth: to
# 12 for the model-zoo phase, to 4 for phase 18, to 2 for phase 22; the
# same turns, concurrency, drop rate and loss point), both on one build
# of the FedLLM main path's model at seq 1024
# (d 512, bf16, the bench's fresh LoRA adapter on the seeded base).
CHAOS_TINY = dict(dataset="llm_synth", model="causal_lm", random_seed=3,
                  llm_hidden_size=32, llm_num_layers=2, llm_num_heads=2,
                  llm_intermediate_size=64, llm_max_seq_len=64, lora_rank=0,
                  llm_attention_impl="dense")
CHAOS_TINY_PLAN = dict(seed=1, serving_nan_at_step=2,
                       serving_stall_at_step=4, serving_stall_s=5.0)
CHAOS_TINY_BATCH = {"slots": 4, "block_size": 16, "prefill_chunk": 8,
                    "watchdog_s": 0.3, "max_resets": 4, "max_requeues": 4,
                    "request_timeout_s": 120.0}
FLEET_CHECK_REQUESTS = 8      # the 7th (0-based 6) is replica 0's request 3
FLEET_CHECK_ARGS = dict(llm_serving_mode="batch", serving_slots=4,
                        serving_kv_block_size=16, serving_prefill_chunk=32,
                        serving_request_timeout_s=120.0,
                        enable_tracking=False)
CHAOS_BENCH = {"concurrency": 8, "requests": 24, "max_new": 12,
               "watchdog_s": 0.3, "legs": (("recovery_on", 64),
                                           ("recovery_off", 0)),
               "plan": dict(seed=13, serving_stall_at_step=12,
                            serving_stall_s=5.0, serving_nan_at_step=25)}
FLEET_REPLICAS, FLEET_CONC, FLEET_LOSS_AT = 3, 256, 0.4
FLEET_LOAD = dict(tenants=8, sessions_per_tenant=2, turns_per_session=3,
                  seed=0, mean_gap_s=0.002, max_tokens=16, turn_chars=200)
# 8,192 KV blocks of 16 at d 512, 4 layers, bf16: 1.07 GB per replica
FLEET_OPTS = {"slots": 16, "block_size": 16, "prefill_chunk": 64,
              "prefix_cache": True, "prefill_batch": 8,
              "request_timeout_s": 600.0, "num_blocks": 8192}

# The model zoo and tasks (phase 15). (a) card against CPU, f32 with TF32
# off and cuDNN on deterministic algorithms, each run within HOUSE_TOL of
# the CPU's: CNNFemnist with dropout on digits (its two dropout masks
# first, card against CPU bit for bit, at its shapes at batch 32); the
# Shakespeare LSTM under FedOpt at hidden 16 (ZOO_NARROW_LSTM: embedding,
# hidden, layers), and its captured step against the eager loop at full
# width on the card (2 clients, CAPTURE_TOL); the multilabel and
# regression tasks; a digits run. 2 rounds each, small learning rates
# (cuDNN's and the LSTM's reductions sum in other orders on the card).
ZOO_CNN = dict(dataset="digits", model="cnn", client_num_in_total=4,
               client_num_per_round=2, comm_round=2, batch_size=8,
               learning_rate=0.01, max_total_samples=64,
               frequency_of_the_test=-1, random_seed=3)
ZOO_LSTM = dict(dataset="shakespeare", model="rnn", client_num_in_total=4,
                client_num_per_round=4, comm_round=2, epochs=1,
                batch_size=16, learning_rate=0.1,
                federated_optimizer="FedOpt", server_optimizer="sgd",
                server_lr=1.0, server_momentum=0.9,
                frequency_of_the_test=-1, random_seed=0)
ZOO_NARROW_LSTM = (8, 16, 2)
ZOO_MULTILABEL = dict(dataset="synthetic_multilabel", model="lr",
                      client_num_in_total=4, client_num_per_round=4,
                      comm_round=2, batch_size=16, learning_rate=0.1,
                      frequency_of_the_test=-1, random_seed=1)
ZOO_REGRESSION = dict(model="lr", client_num_in_total=3,
                      client_num_per_round=3, comm_round=2, batch_size=8,
                      learning_rate=0.05, frequency_of_the_test=-1,
                      random_seed=2)
ZOO_DIGITS = dict(dataset="digits", model="lr", client_num_in_total=10,
                  client_num_per_round=10, comm_round=2, batch_size=32,
                  learning_rate=0.1, frequency_of_the_test=-1,
                  random_seed=0)
# (b) bench.py's bench_engine_mfu_resnet18 (bench.py:1006) at its width:
# ResNet-18, synthetic CIFAR-10 50,000 / 1,000, 64 clients per round,
# bf16, batch 32, lr 0.1, seed 0; cut to the capture, one block of
# ZOO_R18_BLOCK rounds and one eval; legs: as written (fused_conv_block
# off: cuDNN) and with the fused block (B1 on stage 0's two 64-channel
# blocks). Baseline: the SP loop, one round on 8 clients, 6,250 samples.
ZOO_R18 = dict(backend="gpu", dataset="cifar10", model="resnet18",
               precision="bfloat16", client_num_in_total=64,
               client_num_per_round=64, comm_round=1, epochs=1,
               batch_size=32, learning_rate=0.1, frequency_of_the_test=-1,
               random_seed=0, allow_synthetic=True, synthetic_size=50000,
               rounds_per_dispatch=8)
ZOO_R18_BLOCK = 1   # 2 until phase 23 took the time
ZOO_R18_SP = dict(ZOO_R18, backend="sp", client_num_in_total=8,
                  client_num_per_round=8, synthetic_size=6250,
                  max_total_samples=6250)
# (c) bench_shakespeare_fedopt (bench.py:1285) as written: the bundled
# text, 10 roles, 12 rounds, FedOpt (sgd server, lr 1, momentum 0.9),
# epochs 2, batch 16, lr 0.4; round 0 warms up (the capture), rounds 1-11
# timed, an eval after each until the 0.21 target is hit.
ZOO_SHAKESPEARE = dict(dataset="shakespeare", model="rnn",
                       client_num_in_total=10, client_num_per_round=10,
                       comm_round=12, epochs=2, batch_size=16,
                       learning_rate=0.4, federated_optimizer="fedopt",
                       server_optimizer="sgd", server_lr=1.0,
                       server_momentum=0.9, frequency_of_the_test=10000,
                       random_seed=0)
ZOO_SHAKESPEARE_TARGET = 0.21
# (d) bench_time_to_acc (bench.py:217) as written: FedAvg + logistic
# regression on the bundled digits, 10 clients, lr 0.3, batch 32, an eval
# after every round, up to 80 rounds; seconds and rounds to 90 %.
ZOO_DIGITS_BENCH = dict(dataset="digits", model="lr", client_num_in_total=10,
                        client_num_per_round=10, comm_round=80, epochs=1,
                        batch_size=32, learning_rate=0.3,
                        frequency_of_the_test=10000, random_seed=0)
ZOO_DIGITS_TARGET = 0.90

# The cross-silo runtime (phase 16). (a) checks, f32 with TF32 off: the
# reference's tests/test_cross_silo.py session (synthetic MNIST, LR, 4
# silos, 3 rounds, lr 0.1, seed 9) over INPROC on the card against the
# CPU (HOUSE_TOL), over TCP on loopback against INPROC (bitwise), under
# CS_LINK's seeded link loss / duplication / delay (completes, non-empty
# link ledger) and its JSONL records through core/obs/schema.py.
CS_LR = dict(dataset="synthetic_mnist", model="lr", client_num_in_total=4,
             client_num_per_round=4, comm_round=3, epochs=1, batch_size=32,
             learning_rate=0.1, frequency_of_the_test=1, random_seed=9)
CS_LINK = dict(chaos_link_loss_prob=0.08, chaos_link_dup_prob=0.1,
               chaos_link_delay_prob=0.1, chaos_link_delay_s=0.2,
               chaos_seed=31, round_timeout_s=1.5)
# (b) bench.py's bench_cross_silo_wire (bench.py:452) as written: bundled
# digits, LR, 10 silos, 40 rounds in-proc, lr 0.3, batch 32, seed 0, an
# eval every round; dense against topk_qsgd at 0.05 with error feedback
# and the compressed broadcast; model-bearing bytes are the INIT, SYNC and
# C2S_MODEL messages' (the in-proc broker encodes every message).
CS_WIRE = dict(dataset="digits", model="lr", client_num_in_total=10,
               client_num_per_round=10, comm_round=40, epochs=1,
               batch_size=32, learning_rate=0.3, frequency_of_the_test=1,
               random_seed=0)
CS_WIRE_CC = dict(comm_compression="topk_qsgd", comm_compression_ratio=0.05,
                  comm_compression_broadcast="compress")
CS_WIRE_TARGET = 0.90
# (c) the flagship's configuration as a cross-silo session: ResNet-56,
# synthetic CIFAR-10 (hetero, alpha 0.5; its 50,000 training samples cut
# in depth to 25,000 for phase 22, 1,000 test), batch 32, bf16, the fused
# conv block, epochs 1, lr 0.1, seed 0; 4 silos (all of them in
# every round) as subprocesses, the server in this process, over TCP on
# loopback. Round 0 captures each silo's step (untimed); rounds 1..
# CS_FULL_TIMED are timed; the server evaluates after every round.
CS_FULL_TIMED = 1
CS_FULL = dict(dataset="synthetic_cifar10", model="resnet56",
               precision="bfloat16", fused_conv_block="pallas",
               client_num_in_total=4, client_num_per_round=4,
               comm_round=1 + CS_FULL_TIMED, epochs=1, batch_size=32,
               learning_rate=0.1, synthetic_size=25000,
               synthetic_test_size=1000, partition_alpha=0.5,
               frequency_of_the_test=1, random_seed=0)
CS_JOIN_S = 600.0

# The buffered-async cross-silo runtime and the other transports (phase
# 17). (a) checks, f32 with TF32 off: ASYNC_TRACE's scripted upload trace
# (fresh uploads, uploads 1-5 versions stale, one from version 0 past the
# ring cap 4, a topk_qsgd compressed uplink; undefended at K 2, and krum
# at K 4 with one byzantine row x 50) through AsyncFedMLAggregator on the
# card and on the CPU (HOUSE_TOL, the same verdicts); CS_LR over
# PUBSUB_STORAGE (the broker in this process, the store under the run's
# temp dir, the JAX package's 4,096-byte offload threshold: every model
# message goes through the store) and over TRPC (a process per rank), each
# bitwise equal to the INPROC session; CS_LR as an async session (K 2,
# the pour-timeout valve) under CS_LINK's link faults for CS_ASYNC_LR_POURS
# pours (every pour completes, the buffer ledger balances, staleness >= 1).
ASYNC_TRACE = dict(client_num_per_round=5, round_mode="async_buffered",
                   async_alpha=0.8, async_staleness_weighting="polynomial",
                   async_staleness_poly=0.5, async_staleness_cap=4,
                   random_seed=11)
ASYNC_TRACE_KRUM = dict(enable_defense=True, defense_type="krum",
                        byzantine_client_num=1)
ASYNC_TRACE_POURS = 8
CS_ASYNC_LR_POURS = 8
# (b) CS_FULL as a buffered-async session: K 2 of the 4 silos, the silos
# as processes and the server in this process over PUBSUB_STORAGE (model
# payloads through the object store); CS_ASYNC_WARM untimed pours (every
# silo's first training, which holds its capture), then CS_ASYNC_TIMED
# timed pours (one pair; 2 until phase 22: so only that pair's silos
# report a time per step after their first training); the pour-timeout
# valve far above a pour (no partial pour).
CS_ASYNC_WARM = 2
CS_ASYNC_TIMED = 1
CS_ASYNC_FULL = dict(CS_FULL, round_mode="async_buffered", async_buffer_k=2,
                     async_pour_timeout_s=120.0,
                     comm_round=CS_ASYNC_WARM + CS_ASYNC_TIMED)

# The other cross-silo scenarios (phase 18). (a) checks, f32 with TF32
# off: GOSSIP_LR (tests/test_torch_gossip.py's session: bundled digits,
# LR, 4 nodes on a ring, 2 rounds, lr 0.1, seed 5) over INPROC on the card
# against the CPU (HOUSE_TOL), dense and with GOSSIP_CC (3 rounds: every
# compressed N2N blob's kept indices and levels bit for bit, its scale to
# GOSSIP_SCALE_RTOL); the SP decentralized loop on the card against the
# CPU; the split-learning and vertical-FL sessions (MULTIPARTY: 3 clients
# / 3 feature parties, 2 rounds) on the card against their SP simulators
# on the card and against the CPU sessions; the hierarchical session (2
# silos of 1 rank, CS_LR's configuration) against the horizontal session
# on the card, bitwise.
GOSSIP_LR = dict(dataset="digits", model="lr", client_num_in_total=4,
                 client_num_per_round=4, comm_round=2, epochs=1,
                 batch_size=32, learning_rate=0.1, frequency_of_the_test=1,
                 random_seed=5, federated_optimizer="decentralized_fl",
                 topology_neighbors=2)
GOSSIP_CC = dict(gossip_compression="topk_qsgd", comm_compression_ratio=0.1,
                 comm_round=3)
GOSSIP_SCALE_RTOL = 1e-6
MULTIPARTY = dict(dataset="digits", model="lr", client_num_in_total=3,
                  client_num_per_round=3, comm_round=2, epochs=1,
                  batch_size=32, learning_rate=0.1, frequency_of_the_test=1,
                  random_seed=7, party_num=3)
# (b) gossip at the flagship's width: CS_FULL's knobs (ResNet-56, bf16,
# the fused block, 4 nodes on synthetic CIFAR-10 25,000 / 1,000, alpha
# 0.5, batch 32) with federated_optimizer decentralized_fl on a ring
# (topology_neighbors 2); four node processes (silo_main's gossip role)
# over TCP on loopback; round 0 holds each node's capture (untimed),
# GOSSIP_FULL_TIMED rounds are timed; node 0 evaluates the average model
# once, after the last round.
GOSSIP_FULL_TIMED = 1
GOSSIP_FULL = dict(CS_FULL, federated_optimizer="decentralized_fl",
                   topology_neighbors=2, comm_round=1 + GOSSIP_FULL_TIMED)
# (c) bench.py's _gossip_wire_leg (bench.py:409) as written: digits, LR, 4
# nodes, 8 rounds in-proc, lr 0.3, seed 0; dense against
# gossip_compression topk_qsgd at 0.1; N2N bytes per round. Phase 16 (b)
# reports it as the wire bench's legs.gossip_compressed.
GOSSIP_WIRE = dict(dataset="digits", model="lr", client_num_in_total=4,
                   client_num_per_round=4, comm_round=8, epochs=1,
                   batch_size=32, learning_rate=0.3, random_seed=0,
                   federated_optimizer="decentralized_fl")

# Secure aggregation (phase 19). (a) the field math of core/mpc (GF(p), p =
# 2^31 - 1, uint32 values in int64 lanes) on the card against the CPU and
# against an exact integer reference (numpy uint64), bitwise: ff_add /
# ff_sub / ff_neg / ff_mul on FIELD_PAIRS seeded pairs plus FIELD_EDGE,
# each edge value against each; quantize -> dequantize over a vector of the
# flagship's parameter count (seeded normals x 8, ties at half a quantum,
# values past the +-2^29 clip, infinities) and dequantize of seeded field
# values (signed values up to 2^30, which the float32 conversion rounds);
# sum_mod_p over [4, D] and [64, D]; ff_random against prng's host
# threefry.
FIELD_PAIRS = 1 << 20
FIELD_EDGE = (0, 1, 2, 2**16 - 1, 2**16, 2**16 + 1, 2**30, 2**30 + 1,
              2**31 - 3, 2**31 - 2)
# (b) the SA and LSA sessions at the flagship's width: SECAGG_FULL (CS_FULL's
# ResNet-56, bf16, the fused conv block, synthetic CIFAR-10 25,000 in 4
# partitions at alpha 0.5; 1 round) through run_secagg_inproc and
# run_lsa_inproc on the card, so the silos' own on_train (the delta, n x
# delta quantized on the card, fresh X25519 mask keys, sealed shares, the
# SHA-256 masks of the JAX package) and the server's unmask and
# apply_mean_delta run. Each silo's local training is cut to SECAGG_STEPS
# steps (work_scale, through the sessions' client_factory hook); B1 must
# be 27 x (every silo's warm-up + replays + the server's eval batches);
# the session's model must equal plain FedAvg of the same silos' deltas
# (float64, with quantize's +-2^13 clip on n x delta) within the house
# tolerance plus one quantum per silo (2^-16 / sum(n)).
SECAGG_FULL = dict(CS_FULL, comm_round=1)
SECAGG_STEPS = 2
# Phase 20: the roofline of the flagship's step at bench_flagship's widths
# (ResNet-56, batch 32, bf16, B1), cut in depth to 2 of its 64 clients
# for one round (the capture reads one step, whatever the round's depth);
# its step's graph replayed ROOFLINE_STEP_REPLAYS times under CUDA
# events; the serving decode step ROOFLINE_DECODE_STEPS times at 64 slots.
ROOFLINE_PATH = dict(MAIN_PATH, client_num_per_round=2, obs_roofline=True)
ROOFLINE_STEP_REPLAYS = 20
ROOFLINE_DECODE_STEPS = 8
# Phase 21: a cross-device session at the flagship's width (the
# cross-silo flagship's model and data, 4 devices on the card, torch
# engine, B1), 1 round, each device cut to CD_STEPS steps (the device
# path, not training); the same with the JAX tests' uplink compression;
# and tests/test_cross_device.py's native session on digits.
CD_FULL = dict(CS_FULL, comm_round=1, training_type="cross_device")
CD_STEPS = 2
CD_WIRE = dict(device_wire_compression="topk_qsgd",
               comm_compression_ratio=0.1)
CD_NATIVE = dict(dataset="digits", model="lr", client_num_in_total=3,
                 client_num_per_round=3, comm_round=3, epochs=1,
                 batch_size=32, learning_rate=0.2, random_seed=3,
                 training_type="cross_device")
# (c) the dropout algebra at the same width, over the SA session's silo
# deltas: each n x delta quantized on the card and masked on the host by a
# core/mpc SecAggClient (threshold 3 of 4, the stand-in key agreement);
# secagg_unmask with no silo dropped and with silo 3 dropped must give the
# survivors' plain quantized sum (sum_mod_p on the card) bit for bit.
# LightSecAgg's mask_encoding / decode_aggregate_mask (n 4, LSA's
# defaults: privacy_t 1, threshold n - 1, so split_t 2) recover the
# aggregate mask over the same D, with and without silo 3, and unmask the
# masked deltas to the same sum.
# (d) the SA and LSA sessions on SECAGG_LR (CS_LR, 2 rounds) over INPROC
# on the card against the CPU: the house tolerance plus one quantum per
# silo and round (2^-16 / sum(n)). The state machines seal the routed
# shares with the cryptography package; on a host without it both must
# fail at build with the ModuleNotFoundError that names it (a stated
# precondition: (b) to (d) then report "cpu_only").
SECAGG_LR = dict(CS_LR, comm_round=2)
# Phase 16 (b)'s SecAgg leg: bench.py's _secagg_wire_leg (bench.py:269) as
# written: bundled digits, LR, 4 silos, 40 rounds, lr 0.3, seed 0; each
# silo's local SGD from the global model with the key fold_in(PRNGKey(17 +
# silo), round); the dense field leg (quantize at 2^-16, 4 B per
# coordinate) against SECAGG_WIRE_BITS-bit lanes (plan_for(4, 4): 5 lanes
# a word, field_encode with error feedback, rng (silo + 1) * 1000003 +
# round), the pairwise masks seeded (round << 16) ^ (min << 8) ^ max, the
# scale's running average. The JAX bench's acceptance: the masked sum
# equals the plain sum every round, >= 4x fewer bytes than the dense
# field, lane rounds to 90 % within +-2 of the dense leg's.
SECAGG_WIRE = dict(dataset="digits", model="lr", client_num_in_total=4,
                   client_num_per_round=4, comm_round=40, epochs=1,
                   batch_size=32, learning_rate=0.3, frequency_of_the_test=1,
                   random_seed=0)
SECAGG_WIRE_BITS = 4

# Multi-rank on the one card (phase 22): the port's torch.distributed
# ranks, one process each (core/launch.py::run_ranks), built kernels
# loaded, f32 checks with TF32 off and cuDNN held to deterministic
# algorithms. (a) the client axis at the flagship's width (MAIN_PATH's
# widths: ResNet-56, bf16, B1, synthetic CIFAR-10, batch 32, lr 0.1, seed
# 0), cut in depth to 8 of 8 clients over 4,096 samples (16 steps a
# client), 1 round: the plain engine in this process, mesh_shape
# {"client": 1} through the multi-rank path in an NCCL group of 1 (≡ the
# plain engine bitwise), and {"client": 2} on two gloo ranks sharing the
# card, 4 clients each (within HOUSE_TOL of the 1-rank run: only the f32
# sum's order differs; both ranks' params bitwise equal; B1 27 x each
# rank's forwards). (b) ring attention at the FedLLM main path's shape
# (b 8, s 256, h 8, d 64), sp 2 on the two ranks, f32 and bf16, against
# dense attention on the card: the output with and without a key mask
# (row 0's first 16 keys padded: exact zeros there) and dQ, dK, dV, each
# within RING_TOL of the largest dense entry; make_ring_forward of the
# FedLLM model (untied, LoRA off, f32) against its dense forward on the
# real positions (row 0's last 64 tokens padded). (c) one SGD step (lr
# 0.1) of the FedLLM model (flash attention, f32) through the sharded
# step, against the unsharded step on the card: the loss within 1e-5 and every updated parameter within 1e-4
# (tests/test_llm.py's bounds), B2-B4 counted on each rank. On the two
# gloo ranks DTensor's all-gather of the CUDA shards (its functional
# collective, wait_tensor) dies with a segmentation fault, where gloo's
# own all_gather_into_tensor / reduce_scatter_tensor of CUDA tensors run
# (scripts/gloo_cuda_probe.py): the step is not coded around the library,
# so (c) runs at SHARDED_MESH_ONE in the NCCL group of one rank, and the
# two-rank leg waits for cards of their own (ROADMAP.md Queue A 5b).
MULTI_RANK = dict(MAIN_PATH, client_num_in_total=8, client_num_per_round=8,
                  synthetic_size=4096, comm_round=1)
MULTI_RANKS = 2
MULTI_RANK_JOIN_S = 600.0
RING_SHAPE = (8, 256, 8, 64)
RING_DEAD_KEYS = 16
RING_PAD_TOKENS = 64
RING_TOL = {"float32": 1e-4, "bfloat16": 2.0 ** -6}
SHARDED_MESH_ONE = {"fsdp": 1, "tensor": 1}
SHARDED_LR = 0.1
SHARDED_TOL = (1e-5, 1e-4)
PSUM_TIMED = 5
# (c) also steps the model with LoRA adapters on every target (rank 8,
# both factors seeded nonzero, the base trained with them): at
# SHARDED_MESH_ONE in the NCCL group, and on the two gloo ranks at
# SHARDED_MESH_TP2, whose step reaches no DTensor functional collective
# (the factors' gradients are summed over ``tensor`` by the model's own
# all-reduce; local shards are held against the slices of the unsharded
# step, so nothing gathers a DTensor)
SHARDED_MESH_TP2 = {"fsdp": 1, "tensor": 2}
SHARDED_LORA_RANK = 8
# (d) defended rounds over the two gloo ranks: MULTI_RANK with one
# byzantine_flip client and RFA (bench_robust_rfa_weak_scaling's pair),
# robust_fused auto, the relayout as f32 rows and as int8 rows; each held
# against the same run on one rank in this process: f32 within HOUSE_TOL,
# int8's defense input on at most RELAYOUT_FLIP_SHARE other levels, the
# verdicts equal, the ranks' params bitwise equal, B1 27 x each rank's
# forwards. (e) buffered-async pours over the two ranks: MULTI_RANK with
# K 4 of 8 in flight, the bootstrap and 1 timed pour, against one rank
# within HOUSE_TOL, the same cohorts drawn
MULTI_RANK_DEFENDED = dict(MULTI_RANK, enable_attack=True,
                           attack_type="byzantine_flip",
                           byzantine_client_num=1, enable_defense=True,
                           defense_type="rfa", robust_fused="auto")
MULTI_RANK_RELAYOUTS = ("none", "int8")
MULTI_RANK_ASYNC = dict(MULTI_RANK, round_mode="async_buffered",
                        async_buffer_k=4)

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


def time_geometries(torch, F, cb, gen, dtype, geometries=FLAGSHIP):
    """Per-geometry ms at batch 32: the kernel (CUDA events, and device
    time), its plain version, the unfused cuDNN chain (device time as
    ``library_ms``, and CUDA events) and the bound
    (``core/kernels/cost.py``)."""
    from fedml_tpu_torch.core.kernels.cost import block_cost
    dt = getattr(torch, dtype)
    rows = []
    for (h, cin, cout, s), count in geometries:
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
               random_seed=3, fused_conv_block="pallas",
               enable_tracking=False)
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
    block of SCAFFOLD_BLOCK rounds is timed and one eval follows. Returns
    its record and the kernels' launches over the path."""
    from fedml_tpu_torch.core.algframe.types import TrainHyper
    sim = _simulator(SCAFFOLD_PATH)
    hyper = TrainHyper(learning_rate=SCAFFOLD_PATH["learning_rate"])
    reset_launches(cb, fa)
    capture_s = sim.capture_step(hyper)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    block = sim.run_rounds_fused(0, SCAFFOLD_BLOCK, hyper)
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
    round_s = block_s / SCAFFOLD_BLOCK
    return {"rounds_per_hour": 3600.0 / round_s, "step_time_s": round_s,
            "block_s": block_s, "block_rounds": SCAFFOLD_BLOCK,
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


def robust_simulator(cfg, dev=None, fed=None, module=None):
    """A simulator of ``cfg`` (the GPU engine or the SP loop) on ``dev``
    (the card unless given), on ``fed`` when given (the dataset ``cfg``
    loads, loaded once for several legs), of the model ``module()`` builds
    when given (else the one ``cfg`` names)."""
    from fedml_tpu_torch import data, model
    from fedml_tpu_torch.arguments import Arguments
    from fedml_tpu_torch.runner import FedMLRunner
    args = Arguments(**cfg)
    if fed is None:
        fed, _ = data.load(args)
    bundle = (model.create(args, fed.num_classes, fed.input_shape)
              if module is None else model.ModelBundle(module(),
                                                       cfg["model"]))
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
    from fedml_tpu_torch.core.kernels.cost import attention_cost
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


def chaos_tiny_check(torch, llm, Arguments, dev="cuda", cpu="cpu"):
    """CHAOS_TINY's greedy tokens for PARITY_PROMPTS (12 new, four in
    flight) on the card under CHAOS_TINY_PLAN, against the same engine's
    chaos-free run on the card and on the CPU: equal, with two resets and
    the stall seen by the watchdog."""
    import concurrent.futures as cf
    from fedml_tpu_torch.core.chaos import (FaultLedger, FaultPlan,
                                            ServingChaosInjector)
    from fedml_tpu_torch.serving.llm_template import CausalLMPredictor
    bundle, tok = llm.build_llm_bundle(Arguments(**CHAOS_TINY))
    params = {k: v.detach().clone()
              for k, v in bundle.module.state_dict().items()}

    def run(device, plan):
        ledger = FaultLedger()
        inj = None if plan is None else ServingChaosInjector(
            FaultPlan(**plan), ledger=ledger)
        pred = CausalLMPredictor(bundle, params, tokenizer=tok, mode="batch",
                                 device=device, batch_opts=dict(
                                     CHAOS_TINY_BATCH, chaos=inj))
        try:
            with cf.ThreadPoolExecutor(len(PARITY_PROMPTS)) as ex:
                outs = [f.result(timeout=120) for f in [
                    ex.submit(pred.generate, p, max_new_tokens=12)
                    for p in PARITY_PROMPTS]]
            eng = pred.engine
            return outs, {"resets": eng.resets_total,
                          "watchdog_trips": eng.watchdog.trips,
                          "injected": [e["kind"] for e in
                                       ledger.serving_events()],
                          "health": eng.health()["status"]}
        finally:
            pred.close()

    chaos, stats = run(dev, CHAOS_TINY_PLAN)
    clean, _ = run(dev, None)
    on_cpu, _ = run(cpu, None)
    require(stats["injected"] == ["nan", "stall"],
            f"chaos check: injected {stats['injected']}")
    require(stats["resets"] == 2 and stats["watchdog_trips"] >= 1
            and stats["health"] == "ok", f"chaos check: engine {stats}")
    require(chaos == clean, f"chaos check: tokens under chaos {chaos} != "
                            f"the chaos-free run's {clean}")
    require(clean == on_cpu, f"chaos check: card {clean} != CPU {on_cpu}")
    return dict(stats, prompts=len(PARITY_PROMPTS),
                tokens=sum(o["completion_tokens"] for o in chaos))


def subprocess_fleet_check(torch, Arguments, export, tmp, dev="cuda"):
    """Two subprocess replicas on ``dev`` serving the FedLLM export's
    global adapter; the first replica's spec carries
    ``chaos_serving_crash_at_request: 3``. FLEET_CHECK_REQUESTS greedy chat
    requests through the gateway all succeed with the tokens of an
    in-process predictor of the same artifact (the crashed request fails
    over), the crashed process exits 23, and ``health_check`` replaces it
    with a new process that serves the same tokens."""
    from fedml_tpu_torch.serving.autoscale import (
        Gateway, ReplicaSet, subprocess_replica_factory)
    from fedml_tpu_torch.serving.llm_template import CausalLMPredictor
    path = os.path.join(os.path.dirname(export["manifest"]), "global.fmtpu")
    args = Arguments(**dict(LLM_MAIN_PATH, **FLEET_CHECK_ARGS))
    crash = Arguments(**dict(LLM_MAIN_PATH, **FLEET_CHECK_ARGS,
                             chaos_serving_crash_at_request=3))
    factories = [subprocess_replica_factory(
        a, path, 0, os.path.join(tmp, f"replicas_{tag}"), device=dev,
        kind="causal_lm") for a, tag in ((crash, "crash"), (args, "ok"))]
    made = []

    def factory():
        made.append(factories[min(len(made), 1)]())
        return made[-1]

    req = {"messages": [{"role": "user", "content": "add 2 3"}],
           "max_tokens": 8, "temperature": 0}
    lone = CausalLMPredictor.from_artifact(args, path, device=dev)
    rs = gw = None
    try:
        want = lone.chat(dict(req))["choices"][0]["message"]["content"]
        t0 = time.perf_counter()
        rs = ReplicaSet(replica_factory=factory, min_replicas=2,
                        max_replicas=2)
        start_s = time.perf_counter() - t0
        gw = Gateway(rs, window_s=30.0, backoff_seed=0,
                     unhealthy_ttl_s=60.0, max_failovers=3)
        got = [gw.predict(dict(req), timeout=120,
                          path="/v1/chat/completions")
               ["choices"][0]["message"]["content"]
               for _ in range(FLEET_CHECK_REQUESTS)]
        require(got == [want] * FLEET_CHECK_REQUESTS,
                f"subprocess fleet: gateway answers {got} != {want!r}")
        code = made[0].proc.wait(timeout=60)
        require(code == 23, f"subprocess fleet: replica 0 exited {code}")
        pids = [r.pid for r in made]
        t1 = time.perf_counter()
        healed = rs.health_check()
        heal_s = time.perf_counter() - t1
        require(healed == 1 and rs.replicas[0].pid not in pids,
                f"subprocess fleet: health_check replaced {healed}")
        after = gw.predict(dict(req), timeout=120,
                           path="/v1/chat/completions")
        require(after["choices"][0]["message"]["content"] == want,
                "subprocess fleet: the replacement's tokens differ")
        return {"requests": FLEET_CHECK_REQUESTS + 1, "exit_code": code,
                "pids": pids + [rs.replicas[0].pid],
                "start_two_s": start_s, "heal_s": heal_s}
    finally:
        if rs is not None:
            rs.stop()
        for r in made:
            r.stop()
        lone.close()


def fleet_model(torch, llm, Arguments):
    """The chaos bench's and the fleet soak's model, built once: the FedLLM
    main path's base at seq 1024 from its seed, its tokenizer, and a fresh
    LoRA adapter from seed 0."""
    from fedml_tpu_torch.llm.lora import lora_init
    bundle, tok = llm.build_llm_bundle(Arguments(**dict(
        LLM_MAIN_PATH, llm_max_seq_len=1024)))
    adapter = lora_init(torch.Generator().manual_seed(0), bundle.base_params,
                        rank=LLM_MAIN_PATH["lora_rank"])
    return bundle, tok, adapter


def chaos_bench(model, dev="cuda"):
    """bench_llm_serving_chaos on ``fleet_model``: per leg (recovery on: 64
    resets; off: 0) a fresh batch predictor under the same seeded stall +
    NaN plan, one warm request, then CHAOS_BENCH's 24 requests at c8 (odd
    greedy, even sampled at 1.1 with seed i): goodput tokens/s (tokens of
    requests that finished "stop"/"length"), success rate, injected faults,
    resets, watchdog trips; and a chaos-free leg of the same traffic, whose
    outputs each recovery-on output must equal (the seeded replay holds
    for greedy and sampled requests alike)."""
    import concurrent.futures as cf
    from fedml_tpu_torch.core.chaos import (FaultLedger, FaultPlan,
                                            ServingChaosInjector)
    from fedml_tpu_torch.serving.llm_template import CausalLMPredictor
    bundle, tok, adapter = model
    conc, n, max_new = (CHAOS_BENCH["concurrency"], CHAOS_BENCH["requests"],
                        CHAOS_BENCH["max_new"])
    legs, outputs = {}, {}
    for tag, max_resets in CHAOS_BENCH["legs"] + (("chaos_free", 64),):
        ledger = FaultLedger()
        inj = None if tag == "chaos_free" else ServingChaosInjector(
            FaultPlan(**CHAOS_BENCH["plan"]), ledger=ledger)
        pred = CausalLMPredictor(
            bundle, adapter, tokenizer=tok, mode="batch", device=dev,
            batch_opts={"slots": conc, "block_size": 16,
                        "prefill_chunk": 32,
                        "watchdog_s": CHAOS_BENCH["watchdog_s"],
                        "max_resets": max_resets, "max_requeues": 8,
                        "chaos": inj})
        pred._request_timeout_s = 30.0
        try:
            pred.generate("warm", max_new_tokens=2)
            good, ok, outs = [0] * n, [False] * n, [None] * n

            def one(i):
                try:
                    out = pred.generate(
                        f"chaos bench req {i}", max_new_tokens=max_new,
                        temperature=(0.0 if i % 2 else 1.1), seed=i)
                except Exception:  # noqa: BLE001 — recovery off: refused
                    return
                outs[i] = out
                if out["finish_reason"] in ("stop", "length"):
                    ok[i] = True
                    good[i] = out["completion_tokens"]

            t0 = time.perf_counter()
            with cf.ThreadPoolExecutor(conc) as ex:
                list(ex.map(one, range(n)))
            wall = time.perf_counter() - t0
            eng = pred.engine
            outputs[tag] = outs
            legs[tag] = {"goodput_tokens_per_s": sum(good) / wall,
                         "success_rate": sum(ok) / n, "wall_s": wall,
                         "injected_faults": len(ledger.serving_events()),
                         "engine_resets": int(eng.resets_total),
                         "watchdog_trips": int(eng.watchdog.trips),
                         "decode_steps": int(eng.scheduler.steps_run)}
        finally:
            pred.close()
    on, off = legs["recovery_on"], legs["recovery_off"]
    require(on["success_rate"] == 1.0 and on["injected_faults"] == 2
            and on["engine_resets"] == 2,
            f"chaos bench: recovery on {on}")
    require(off["injected_faults"] >= 1 and off["engine_resets"] == 0,
            f"chaos bench: recovery off {off}")
    require(legs["chaos_free"]["success_rate"] == 1.0,
            f"chaos bench: chaos-free leg {legs['chaos_free']}")
    same = sum(a is not None and b is not None and a["text"] == b["text"]
               for a, b in zip(outputs["recovery_on"],
                               outputs["chaos_free"]))
    require(same == n, f"chaos bench: {same} of {n} recovery-on outputs "
                       f"equal the chaos-free leg's")
    return {"legs": legs, "vs_baseline": on["goodput_tokens_per_s"]
            / max(off["goodput_tokens_per_s"], 1e-9),
            "recovery_on_outputs_equal_chaos_free": same,
            "requests": n, "concurrency": conc, "max_new": max_new}


def fleet_soak(torch, model, fleet_on, load, replicas=FLEET_REPLICAS,
               conc=FLEET_CONC, loss_at=FLEET_LOSS_AT, dev="cuda"):
    """One leg of bench_llm_serving_fleet on ``fleet_model``: ``replicas``
    in-process batch replicas (FLEET_OPTS; +1 burst
    replica allowed) behind the gateway with the seeded 4 % connection
    drops, ``load``'s sessions streamed at ``conc``, the last replica
    stopped once ``loss_at`` of the requests have finished (None: no loss)
    and the autoscaler stepping every 0.3 s from then on. ON: cache-aware
    routing, suffix cache, drain grace, heal probes, SLOPolicy; OFF: round
    robin, prompt-only prefix cache, an EWM policy that never scales."""
    import threading

    from fedml_tpu_torch.core.chaos import (FaultLedger, FaultPlan,
                                            ServingChaosInjector)
    from fedml_tpu_torch.serving.autoscale import (Autoscaler, EWMPolicy,
                                                   Gateway, ReplicaSet,
                                                   SLOPolicy)
    from fedml_tpu_torch.serving.llm_template import (CausalLMPredictor,
                                                      ChatCompletionRunner)
    from scripts.serving_load_torch import LoadSpec, run_load
    bundle, tok, adapter = model
    spec = LoadSpec(**load)
    total = spec.total_requests
    ledger = FaultLedger()
    chaos = ServingChaosInjector(
        FaultPlan(seed=17, serving_conn_drop_prob=0.04), ledger=ledger)
    opts = dict(FLEET_OPTS, suffix_cache=fleet_on)
    built = []

    def factory():
        built.append(CausalLMPredictor(bundle, adapter, tokenizer=tok,
                                       mode="batch", stream=True, device=dev,
                                       batch_opts=dict(opts)))
        return built[-1]

    rs = ReplicaSet(predictor_factory=factory, min_replicas=replicas,
                    max_replicas=replicas + 1,
                    runner_cls=ChatCompletionRunner,
                    drain_grace_s=2.0 if fleet_on else 0.0)
    gw = Gateway(rs, unhealthy_ttl_s=0.75, max_failovers=4, backoff_seed=0,
                 chaos=chaos, cache_aware=fleet_on, heal_probe=fleet_on)
    policy = (SLOPolicy(queue_depth_per_replica=32.0, kv_headroom_min=1,
                        cooldown_s=3.0) if fleet_on
              else EWMPolicy(target_qps_per_replica=1e9))
    asc = Autoscaler(gw, policy, interval_s=0.25)
    lock = threading.Lock()
    ttfts, tokens, oks = [], [], []
    mark = [None]
    done = threading.Event()

    def send(messages, meta):
        req = {"messages": messages, "stream": True,
               "max_tokens": int(meta["max_tokens"]),
               "temperature": float(meta["temperature"]),
               "seed": int(meta["seed"])}
        t0 = time.perf_counter()
        first, parts, usage = None, [], None
        try:
            for data in gw.stream(req, timeout=600.0):
                ch = json.loads(data)["choices"][0]
                delta = ch.get("delta") or {}
                if delta.get("content"):
                    if first is None:
                        first = time.perf_counter() - t0
                    parts.append(delta["content"])
                if ch.get("finish_reason"):
                    usage = ch.get("usage") or {}
        except Exception:
            with lock:
                oks.append(False)
            raise
        with lock:
            oks.append(True)
            if first is not None:
                ttfts.append(first)
            tokens.append(int((usage or {}).get("completion_tokens",
                                                len(parts))))
        return "".join(parts)

    def disrupt():
        while not done.is_set():
            with lock:
                if len(oks) >= int(loss_at * total):
                    break
            time.sleep(0.05)
        if done.is_set():
            return
        with rs._lock:
            victim = rs.replicas[-1] if rs.replicas else None
        if victim is not None:
            victim.stop()           # replica loss, mid-soak
        with lock:
            mark[0] = len(oks)
        while not done.is_set():
            try:
                asc.step()   # heal + replace + SLO scale
            except Exception:  # noqa: BLE001 — the soak records, goes on
                pass
            done.wait(0.3)

    try:
        for r in list(rs.replicas):   # warm each engine thread once
            r.predictor.generate("fleet warmup", max_new_tokens=2)
        torch.cuda.synchronize()
        watcher = None
        if loss_at is not None:
            watcher = threading.Thread(target=disrupt, daemon=True)
            watcher.start()
        t0 = time.perf_counter()
        records = run_load(send, spec, concurrency=conc)
        wall = time.perf_counter() - t0
        done.set()
        if watcher is not None:
            watcher.join(timeout=30.0)
        with rs._lock:
            engines = [r.predictor.engine for r in rs.replicas]
        idx = [e.scheduler._index for e in engines
               if e.scheduler._index is not None]
        hits = sum(i.hits for i in idx)
        lookups = hits + sum(i.misses for i in idx)
        with lock:
            post = oks[mark[0]:] if mark[0] is not None else []
            ttft = sorted(ttfts)
            leg = {
                "tokens_per_s": sum(tokens) / wall, "wall_s": wall,
                "requests": len(records), "tokens": sum(tokens),
                "ttft_mean_s": sum(ttft) / max(len(ttft), 1),
                "ttft_p99_s": ttft[min(len(ttft) - 1, int(
                    0.99 * (len(ttft) - 1) + 0.5))] if ttft else 0.0,
                "success_rate": sum(oks) / max(len(oks), 1),
                "post_loss_success_rate": sum(post) / max(len(post), 1),
                "post_loss_requests": len(post),
                "suffix_hits": sum(i.suffix_hits for i in idx),
                "suffix_tokens_reused": sum(i.suffix_tokens_reused
                                            for i in idx),
                "prefix_hit_rate": hits / max(lookups, 1),
                "scale_events": int(asc.scale_events),
                "injected_conn_drops": len(ledger.serving_events()),
                "replicas_end": len(rs), "routes": dict(gw.route_counts),
                "decode_steps": sum(int(e.scheduler.steps_run)
                                    for e in engines),
                "resets": sum(int(e.resets_total) for e in engines)}
        return leg
    finally:
        done.set()
        rs.stop()
        for p in built:
            p.close()


def fleet_phase(torch, llm, cb, fa, Arguments, export, tmp, dev="cuda",
                load=FLEET_LOAD):
    """Phase 13: the checks, the chaos bench and the two fleet legs; the
    kernels' launches over all of it (none expected: batch mode's
    attention is cached_attention). Returns the fleet line and the
    launches."""
    t0 = time.perf_counter()
    reset_launches(cb, fa)
    checks = {"chaos_tiny": chaos_tiny_check(torch, llm, Arguments, dev)}
    print(f"fleet checks: chaos tiny {json.dumps(checks['chaos_tiny'])}",
          flush=True)
    checks["subprocess_fleet"] = subprocess_fleet_check(
        torch, Arguments, export, tmp, dev)
    print(f"fleet checks: subprocess replicas "
          f"{json.dumps(checks['subprocess_fleet'])}", flush=True)
    model = fleet_model(torch, llm, Arguments)
    chaos = chaos_bench(model, dev)
    legs = {}
    for tag, on in (("fleet_off", False), ("fleet_on", True)):
        legs[tag] = fleet_soak(torch, model, on, load, dev=dev)
        print(f"fleet {tag}: {json.dumps(legs[tag])}", flush=True)
        require(legs[tag]["success_rate"] == 1.0
                and legs[tag]["post_loss_success_rate"] == 1.0
                and legs[tag]["post_loss_requests"] > 0,
                f"fleet {tag}: a request failed or no loss happened "
                f"{legs[tag]}")
        total = (load["tenants"] * load["sessions_per_tenant"]
                 * load["turns_per_session"])
        require(legs[tag]["tokens"] > 0 and legs[tag]["requests"] == total,
                f"fleet {tag}: {legs[tag]['requests']} of {total} requests "
                f"played")
    require(legs["fleet_on"]["suffix_hits"] > 0,
            f"fleet_on: no suffix hit {legs['fleet_on']}")
    used = launches(cb, fa)
    require(not any(used.values()), f"the fleet phase launched {used}: "
                                    f"batch mode runs no kernel")
    on, off = legs["fleet_on"], legs["fleet_off"]
    return {"checks": checks, "chaos": chaos, "legs": legs,
            "vs_baseline": on["tokens_per_s"] / max(off["tokens_per_s"],
                                                    1e-9),
            "ttft_reduction": off["ttft_mean_s"] / max(on["ttft_mean_s"],
                                                       1e-9),
            "replicas": FLEET_REPLICAS, "concurrency": FLEET_CONC,
            "load": load, "phase_s": time.perf_counter() - t0}, used


def _zoo_card_vs_cpu(torch, cfg, dev, cpu, fed=None, module=None):
    """``cfg`` through the GPU engine on ``dev`` and on ``cpu`` from the
    same seeded params; the card's params over HOUSE_TOL of the CPU's."""
    card = robust_simulator(cfg, dev, fed, module)
    card.run()
    ref = robust_simulator(cfg, cpu, fed, module)
    ref.run()
    ratio = _house_ratio(torch, card.params, ref.params)
    return ratio, card


def _regression_fed():
    """A seeded linear-regression dataset (no loader declares the task,
    in the JAX package either): 3 clients of 6 features."""
    import numpy as np
    from fedml_tpu_torch.data.containers import build_federated_dataset
    rs = np.random.RandomState(0)
    w = rs.randn(6).astype(np.float32)
    cxs = [rs.randn(n, 6).astype(np.float32) for n in (20, 13, 27)]
    cys = [x @ w + 0.1 * rs.randn(len(x)).astype(np.float32) for x in cxs]
    tx = rs.randn(30, 6).astype(np.float32)
    return build_federated_dataset(cxs, cys, tx, tx @ w, 8, 1,
                                   task="regression")


def zoo_agreement(torch, tmp, dev="cuda", cpu="cpu"):
    """Phase 15 (a): the new models and tasks on the card against the CPU
    (ZOO_*). Returns {check: record}."""
    from fedml_tpu_torch import data, prng
    from fedml_tpu_torch.arguments import Arguments
    from fedml_tpu_torch.core.algframe.client_trainer import (
        SequenceTrainer, make_inner_optimizer)
    from fedml_tpu_torch.core.algframe.local_training import (
        StepProgram, batch_real_of, run_local_sgd)
    from fedml_tpu_torch.core.algframe.types import TrainHyper
    from fedml_tpu_torch.model import ModelBundle
    from fedml_tpu_torch.model.dropout import Dropout
    from fedml_tpu_torch.model.nlp.rnn import RNNShakespeare

    out = {}
    torch.backends.cudnn.deterministic = True
    try:
        masks = 0
        for seed in range(3):
            key = prng.PRNGKey(seed)
            for rate, name, shape in ((0.25, "Dropout_0", (32, 14, 14, 64)),
                                      (0.5, "Dropout_1", (32, 128))):
                d = Dropout(rate, name).train()
                x = torch.ones(shape)
                a = d(x.to(dev), prng.key_t(key, dev)).cpu()
                b = d(x, prng.key_t(key, cpu))
                require(torch.equal(a, b), f"dropout {name} seed {seed}: "
                                           f"the card's mask differs")
                masks += a.numel()
        ratio, card = _zoo_card_vs_cpu(torch, ZOO_CNN, dev, cpu)
        require(ratio <= 1.0, f"CNNFemnist with dropout: card vs CPU "
                              f"{ratio:.2f}x the house tolerance")
        out["cnn_dropout"] = {"mask_elements_bitwise": masks,
                              "house_ratio": ratio,
                              "captures": card.dispatch_stats["captures"]}

        lstm = dict(ZOO_LSTM, data_cache_dir=tmp)
        fed, n_out = data.load(Arguments(**lstm))
        e, h, layers = ZOO_NARROW_LSTM
        ratio, card = _zoo_card_vs_cpu(
            torch, lstm, dev, cpu, fed,
            module=lambda: RNNShakespeare(n_out, e, h, layers))
        require(ratio <= 1.0, f"LSTM FedOpt: card vs CPU {ratio:.2f}x the "
                              f"house tolerance")
        # the full-width LSTM's captured step against the eager loop
        bundle = ModelBundle(RNNShakespeare(n_out), "rnn")
        params = bundle.init(torch.Generator().manual_seed(0), dev)
        spec = SequenceTrainer(bundle.apply)
        opt = make_inner_optimizer("sgd", 0.4)
        hyper = TrainHyper(learning_rate=0.4)
        train = fed.train.to(torch.device(dev))
        program = StepProgram(spec, opt, params, train.client(0))
        worst = 0.0
        for cid in range(2):
            cdata, key = train.client(cid), prng.fold_in(prng.PRNGKey(0),
                                                         cid)
            real = batch_real_of(fed.train.mask[cid])
            pg, steps, _ = program.run(params, cdata, key, hyper, real)
            pe, _, _ = run_local_sgd(spec, opt, params, cdata, key, hyper,
                                     batch_real=real)
            moved = max((pe[k] - params[k]).abs().max().item() for k in pe)
            diff = max((pg[k] - pe[k]).abs().max().item() for k in pe)
            require(steps > 0 and moved > 0, "LSTM: a client did not train")
            worst = max(worst, diff / moved / CAPTURE_TOL["float32"])
        require(worst <= 1.0, f"LSTM captured step vs eager loop: off by "
                              f"{worst:.2f}x the tolerance")
        out["lstm_fedopt"] = {"house_ratio": ratio,
                              "captured_vs_eager": worst,
                              "captures": program.captures,
                              "replays": program.replays}

        ratio, _ = _zoo_card_vs_cpu(torch, ZOO_MULTILABEL, dev, cpu)
        require(ratio <= 1.0, f"multilabel: card vs CPU {ratio:.2f}x the "
                              f"house tolerance")
        out["multilabel"] = {"house_ratio": ratio}
        ratio, card = _zoo_card_vs_cpu(torch, ZOO_REGRESSION, dev, cpu,
                                       _regression_fed())
        require(ratio <= 1.0 and type(card.spec).__name__ ==
                "RegressionTrainer", f"regression: card vs CPU {ratio:.2f}x "
                                     f"the house tolerance")
        out["regression"] = {"house_ratio": ratio}
        ratio, card = _zoo_card_vs_cpu(torch, ZOO_DIGITS, dev, cpu)
        require(ratio <= 1.0 and card.fed.provenance == "real",
                f"digits: card vs CPU {ratio:.2f}x the house tolerance "
                f"({card.fed.provenance} data)")
        out["digits"] = {"house_ratio": ratio}
    finally:
        torch.backends.cudnn.deterministic = False
    return out


def _bytes(tensors):
    return int(sum(t.numel() * t.element_size() for t in tensors))


def zoo_resnet18(torch, cb, fa, tmp, cfg=ZOO_R18, sp_cfg=ZOO_R18_SP,
                 block=ZOO_R18_BLOCK, dev="cuda"):
    """Phase 15 (b): bench_engine_mfu_resnet18 on the port, cuDNN and fused
    legs. Returns ({leg: record}, {leg: launches})."""
    from fedml_tpu_torch import data
    from fedml_tpu_torch.arguments import Arguments
    from fedml_tpu_torch.core.algframe.types import TrainHyper
    from fedml_tpu_torch.core.obs import profiler

    cfg = dict(cfg, data_cache_dir=tmp)
    fed, _ = data.load(Arguments(**cfg))
    hyper = TrainHyper(learning_rate=cfg["learning_rate"], epochs=1)
    legs, counts, flops = {}, {}, None
    for leg, fused in (("cudnn", False), ("fused", True)):
        sim = robust_simulator(dict(cfg, fused_conv_block=fused), dev, fed)
        reset_launches(cb, fa)
        capture_s = sim.capture_step(hyper)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rounds = sim.run_rounds_fused(0, block, hyper)
        torch.cuda.synchronize()
        block_s = time.perf_counter() - t0
        ev = sim.evaluate()
        torch.cuda.synchronize()
        counts[leg] = launches(cb, fa)
        require(all(math.isfinite(m["loss_sum"]) for m in rounds)
                and math.isfinite(ev["test_loss"]),
                f"resnet18 {leg}: non-finite metrics")
        require(sim.dispatch_stats["captures"] == 1 and len(sim.programs)
                == 1, f"resnet18 {leg}: {sim.dispatch_stats['captures']} "
                      f"captures")
        (program,) = sim.programs.values()
        steps = sum(m["local_steps"] for m in rounds)
        n_eval = int(sim.test["x"].shape[0])
        forwards = program.warmup_steps + program.replays + n_eval
        per = 2 if fused else 0
        require(program.replays == steps and counts[leg] == {
            "conv_block": per * forwards, "flash_fwd": 0, "flash_dq": 0,
            "flash_dkv": 0}, f"resnet18 {leg}: launches {counts[leg]} for "
                             f"{forwards} forwards, expected {per} B1 each")
        require(program.graph_launches.get(cb.fused_block, 0) == per,
                f"resnet18 {leg}: the captured step holds "
                f"{program.graph_launches.get(cb.fused_block, 0)} B1")
        if flops is None:
            flops = sim.round_cost_flops(hyper)
        round_s = block_s / block
        legs[leg] = {
            "rounds_per_hour": 3600.0 / round_s, "step_time_s": round_s,
            "block_s": block_s, "block_rounds": block,
            "local_steps": steps, "ms_per_local_step": block_s / steps * 1e3,
            "round_flops": flops, "tflops": flops / round_s / 1e12,
            "mfu": profiler.mfu_value(flops, round_s, 1, device="cuda"),
            "capture_s": capture_s, "captures": program.captures,
            "b1_launches": counts[leg]["conv_block"],
            "b1_per_forward": counts[leg]["conv_block"] / forwards,
            "data_bytes": _bytes(list(vars(sim.train).values())
                                 + list(sim.test.values())),
            "model_bytes": _bytes(sim.params.values()),
            "test_acc_after_block": ev["test_acc"],
            "hbm_peak_gb": profiler.sample_hbm_peak_gb("cuda"),
            "data_provenance": fed.provenance}
        del sim, program
    sp = robust_simulator(dict(sp_cfg, data_cache_dir=tmp), dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sp.run(1)
    torch.cuda.synchronize()
    sp_round_s = time.perf_counter() - t0
    samples = float(fed.client_num_samples.sum())
    sp_samples = float(sp.fed.client_num_samples.sum())
    for r in legs.values():
        r["sp_baseline_round_s"] = sp_round_s
        r["vs_baseline"] = (sp_round_s / sp_samples) / (
            r["step_time_s"] / samples)
    return legs, counts


def zoo_bench(torch, cfg, target, timed_from, tmp, dev="cuda"):
    """Phase 15 (c)/(d): a bench that runs rounds one at a time with an
    eval after each (until ``target``, or every round): the rounds before
    ``timed_from`` warm up; rounds/hour over the timed rounds' training
    alone, seconds to the target over the wall from the first timed round
    (evals included), rounds to the target, the final accuracy."""
    from fedml_tpu_torch.core.algframe.types import TrainHyper

    cfg = dict(cfg, data_cache_dir=tmp)
    sim = robust_simulator(cfg, dev)
    hyper = TrainHyper(learning_rate=cfg["learning_rate"],
                       epochs=cfg["epochs"])
    steps = 0
    for r in range(timed_from):
        steps += sim.run_round(r, hyper)["local_steps"]
    torch.cuda.synchronize()
    train_s, t_hit, hit, acc = 0.0, None, None, None
    t0 = time.perf_counter()
    for r in range(timed_from, cfg["comm_round"]):
        r0 = time.perf_counter()
        steps += sim.run_round(r, hyper)["local_steps"]
        torch.cuda.synchronize()
        train_s += time.perf_counter() - r0
        if t_hit is None or timed_from == 0:
            acc = sim.evaluate()["test_acc"]
            if t_hit is None and acc >= target:
                t_hit, hit = time.perf_counter() - t0, r
    total_s = time.perf_counter() - t0
    acc = sim.evaluate()["test_acc"]
    require(all(torch.isfinite(v).all().item() for v in sim.params.values()),
            f"{cfg['dataset']}: non-finite params")
    timed = cfg["comm_round"] - timed_from
    return {"rounds_per_hour": 3600.0 * timed / train_s,
            "round_s": train_s / timed, "final_acc": acc,
            "target_acc": target, "time_to_target_s": t_hit,
            "rounds_to_target": hit, "total_s": total_s,
            "rounds": cfg["comm_round"],
            "local_steps": steps,
            "captures": sim.dispatch_stats["captures"],
            "replays": sim.dispatch_stats.get("replays"),
            "data_provenance": sim.fed.provenance}


def zoo_phase(torch, cb, fa, tmp, dev="cuda", cpu="cpu"):
    """Phase 15: the model zoo and tasks. Each leg zeroes the launch
    counts before it and reads them after. Returns (the ``zoo`` record,
    the ResNet-18 legs' launches)."""
    t_phase = time.perf_counter()
    reset_launches(cb, fa)
    t0 = time.perf_counter()
    checks = zoo_agreement(torch, tmp, dev, cpu)
    checks_s = time.perf_counter() - t0
    require(launches(cb, fa) == {"conv_block": 0, "flash_fwd": 0,
                                 "flash_dq": 0, "flash_dkv": 0},
            f"zoo checks launched {launches(cb, fa)}")
    r18, r18_launches = zoo_resnet18(torch, cb, fa, tmp, dev=dev)
    out = {"checks": checks, "checks_s": checks_s, "resnet18": r18}
    for name, cfg, target, timed_from in (
            ("shakespeare_fedopt", ZOO_SHAKESPEARE, ZOO_SHAKESPEARE_TARGET,
             1),
            ("digits_time_to_acc", ZOO_DIGITS_BENCH, ZOO_DIGITS_TARGET, 0)):
        reset_launches(cb, fa)
        out[name] = zoo_bench(torch, cfg, target, timed_from, tmp, dev)
        require(launches(cb, fa) == {"conv_block": 0, "flash_fwd": 0,
                                     "flash_dq": 0, "flash_dkv": 0},
                f"{name} launched {launches(cb, fa)}")
        require(out[name]["captures"] == 1, f"{name}: "
                                            f"{out[name]['captures']} "
                                            f"captures")
    require(out["digits_time_to_acc"]["data_provenance"] == "real"
            and out["shakespeare_fedopt"]["data_provenance"] == "real",
            "the digits or Shakespeare data is not the bundled real set")
    out["phase_s"] = time.perf_counter() - t_phase
    return out, r18_launches


def free_port_base(n):
    """A base port whose ``n`` ports from it are free on loopback now (a
    TCP session listens on ``base + rank``)."""
    import random
    import socket
    rng = random.Random(os.getpid() ^ time.time_ns())
    for _ in range(200):
        base = rng.randint(20000, 60000 - n)
        socks = []
        try:
            for i in range(n):
                sk = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
                socks.append(sk)
                sk.bind(("127.0.0.1", base + i))
            return base
        except OSError:
            continue
        finally:
            for sk in socks:
                sk.close()
    raise SmokeFailure("no free range of ports on loopback")


def _listening(port) -> bool:
    import socket
    try:
        with socket.create_connection(("127.0.0.1", port), timeout=0.5):
            return True
    except OSError:
        return False


def cs_session(cfg, dev, backend="INPROC", join_s=120.0):
    """One cross-silo session of ``cfg`` with every party on ``dev``: the
    server and each silo on a thread of this process, over ``backend``
    (INPROC, TCP on free loopback ports, or PUBSUB_STORAGE through a
    broker in this process and the object store at
    ``FEDML_TPU_STORAGE_DIR``). Returns (server, silos); a session that
    does not finish within ``join_s`` fails."""
    import copy
    import threading

    from fedml_tpu_torch import data, model
    from fedml_tpu_torch.arguments import Arguments
    from fedml_tpu_torch.core.distributed.communication.inproc import \
        InProcBroker
    from fedml_tpu_torch.cross_silo.horizontal.runner import (build_client,
                                                              build_server)
    n = cfg["client_num_per_round"]
    args = Arguments(**cfg, training_type="cross_silo")
    broker = None
    if backend == "TCP":
        args.tcp_base_port = free_port_base(n + 1)
    elif backend == "PUBSUB_STORAGE":
        from fedml_tpu_torch.core.distributed.communication.pubsub import \
            PubSubBroker
        broker = PubSubBroker()
        args.pubsub_broker_port = broker.port
    else:
        args.inproc_broker = InProcBroker()
    fed, output_dim = data.load(args)
    bundle = model.create(args, output_dim, fed.input_shape)
    server = build_server(args, fed, bundle, backend=backend, device=dev)
    silos = [build_client(args, fed, copy.deepcopy(bundle), rank=r,
                          backend=backend, device=dev)
             for r in range(1, n + 1)]
    threads = [threading.Thread(target=c.run, daemon=True) for c in silos]
    for t in threads:
        t.start()
    st = threading.Thread(target=server.run, daemon=True)
    st.start()
    st.join(timeout=join_s)
    ok = not st.is_alive() and server.result is not None
    for c, t in zip(silos, threads):
        t.join(timeout=2.0)
        if t.is_alive():   # a lost FINISH (link faults) leaves it waiting
            c.finish()
            t.join(timeout=2.0)
    if broker is not None:
        broker.stop()
    require(ok, f"cross-silo session ({backend}, {dev}) did not finish "
                f"within {join_s} s")
    return server, silos


def cs_checks(torch, fedml, tmp, dev="cuda", cpu="cpu"):
    """Phase 16 (a). Returns {check: record}."""
    from fedml_tpu_torch.arguments import Arguments
    from fedml_tpu_torch.core import mlops
    from fedml_tpu_torch.core.chaos import ChaosCommManager
    from fedml_tpu_torch.core.obs import schema

    out = {}
    card, _ = cs_session(CS_LR, dev, "INPROC")
    ref, _ = cs_session(CS_LR, cpu, "INPROC")
    ratio = _house_ratio(torch, card.result["params"], ref.result["params"])
    require(ratio <= 1.0, f"cross-silo LR session: card vs CPU at {ratio:.3f}"
                          f" of HOUSE_TOL")
    out["inproc_card_vs_cpu"] = {
        "of_tolerance": ratio,
        "test_acc": [card.result["final_test_acc"],
                     ref.result["final_test_acc"]]}
    tcp, _ = cs_session(CS_LR, dev, "TCP")
    same = all(torch.equal(tcp.result["params"][k], v)
               for k, v in card.result["params"].items())
    require(same, "cross-silo LR session: TCP params differ from INPROC's")
    out["tcp_vs_inproc_bitwise"] = same
    log_dir = os.path.join(tmp, "cs_logs")
    fedml.init(Arguments(**CS_LR, training_type="cross_silo",
                         log_file_dir=log_dir, run_id="cs_link"))
    try:
        t0 = time.perf_counter()
        server, silos = cs_session(dict(CS_LR, **CS_LINK), dev, "INPROC")
        link_s = time.perf_counter() - t0
    finally:
        path = mlops.log_path()
        mlops.init(Arguments(enable_tracking=False))
    events = [e for m in [server] + silos
              if isinstance(m.com_manager, ChaosCommManager)
              for e in m.com_manager.ledger.links()]
    require(len(server.result["history"]) == CS_LR["comm_round"] and events,
            f"link-fault session: {len(server.result['history'])} rounds, "
            f"{len(events)} link faults")
    out["link_faults"] = {
        "rounds": len(server.result["history"]), "faults": len(events),
        "lost": sum(e["copies"] == 0 for e in events),
        "duplicated": sum(e["copies"] > 1 for e in events),
        "delayed": sum(e["delay_s"] > 0 for e in events),
        "final_test_acc": server.result["final_test_acc"], "wall_s": link_s}
    with open(path) as f:
        lines = [ln for ln in f if ln.strip()]
    errors = schema.validate_lines(lines)
    kinds = sorted({json.loads(ln)["kind"] for ln in lines})
    require(not errors and "comm" in kinds and "chaos" in kinds,
            f"mlops records: {len(errors)} schema errors ({errors[:3]}), "
            f"kinds {kinds}")
    out["records"] = {"lines": len(lines), "kinds": kinds}
    return out


def cs_wire_bench(torch, tmp, dev="cuda"):
    """Phase 16 (b): bench_cross_silo_wire on ``dev``, dense then
    compressed, with its SecAgg leg (phase 19's) and its gossip leg (phase
    18 (c)). Returns the bench's record."""
    from fedml_tpu_torch.core.distributed.communication.message import \
        WIRE_STATS
    from fedml_tpu_torch.cross_silo.message_define import MyMessage

    types = (str(MyMessage.MSG_TYPE_S2C_INIT_CONFIG),
             str(MyMessage.MSG_TYPE_S2C_SYNC_MODEL_TO_CLIENT),
             str(MyMessage.MSG_TYPE_C2S_SEND_MODEL_TO_SERVER))
    rounds = CS_WIRE["comm_round"]

    def session(**cc):
        WIRE_STATS.reset()
        t0 = time.perf_counter()
        server, _ = cs_session(dict(CS_WIRE, data_cache_dir=tmp, **cc), dev)
        wall = time.perf_counter() - t0
        by_type = WIRE_STATS.snapshot()["by_type"]
        model_bytes = sum(by_type.get(t, {"bytes": 0})["bytes"]
                          for t in types)
        accs = [h.get("test_acc", 0.0) for h in server.result["history"]]
        hit = next((i for i, a in enumerate(accs) if a >= CS_WIRE_TARGET),
                   None)
        require(all(torch.isfinite(v).all().item()
                    for v in server.result["params"].values()),
                "wire bench: non-finite params")
        return {"bytes_per_round": model_bytes / rounds,
                "final_acc": accs[-1] if accs else 0.0,
                "rounds_to_target": hit, "wall_s": wall}

    off = session()
    on = session(**CS_WIRE_CC)
    reduction = (off["bytes_per_round"] / on["bytes_per_round"]
                 if on["bytes_per_round"] else None)
    gossip = gossip_wire_leg(tmp, dev)
    secagg = secagg_wire_leg(torch, tmp, dev)
    return {"metric": "fedavg_cross_silo_wire_bytes_per_round",
            "value": on["bytes_per_round"],
            "vs_baseline": reduction,
            "dense_bytes_per_round": off["bytes_per_round"],
            "compressed_final_acc": on["final_acc"],
            "dense_final_acc": off["final_acc"],
            "target_acc": CS_WIRE_TARGET,
            "compressed_rounds_to_target": on["rounds_to_target"],
            "dense_rounds_to_target": off["rounds_to_target"],
            "compressed_wall_s": on["wall_s"], "dense_wall_s": off["wall_s"],
            "legs": {"secagg_compressed": secagg,
                     "gossip_compressed": gossip}}


def cs_flagship(torch, cb, fa, fedml, tmp, cfg=CS_FULL, dev="cuda",
                join_s=CS_JOIN_S):
    """Phase 16 (c): ``cfg`` as a cross-silo session over TCP, the server
    through ``run_cross_silo_server`` in this process and each silo a
    ``python -m fedml_tpu_torch.cross_silo.silo_main`` process on ``dev``.
    Returns (the record, the server's launches, each silo's record)."""
    import threading

    from fedml_tpu_torch.core.distributed.communication.message import \
        WIRE_STATS
    from fedml_tpu_torch.cross_silo.message_define import MyMessage

    n = cfg["client_num_per_round"]
    base = free_port_base(n + 1)
    kw = dict(cfg, backend="TCP", tcp_base_port=base, data_cache_dir=tmp,
              enable_tracking=False)
    procs, logs, box = [], [], {}
    t_start = time.perf_counter()
    reset_launches(cb, fa)
    WIRE_STATS.reset()
    held = 0
    if dev != "cpu":
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()   # what earlier phases hold

    def serve():
        try:
            box["result"] = fedml.run_cross_silo_server(device=dev, **kw)
        except BaseException as e:   # reported below
            box["error"] = e

    # the server listens before the silos announce themselves (a silo's
    # ONLINE gives up after its retries)
    st = threading.Thread(target=serve, daemon=True)
    st.start()
    deadline = time.perf_counter() + join_s
    while not _listening(base) and st.is_alive():
        require(time.perf_counter() < deadline,
                "cross-silo flagship: the server never listened")
        time.sleep(0.2)
    # the host's cores shared out: n silos and the server on one host
    env = dict(os.environ, OMP_NUM_THREADS=str(max(
        1, (os.cpu_count() or 1) // (n + 1))))
    try:
        for r in range(1, n + 1):
            spec = os.path.join(tmp, f"silo_{r}.json")
            with open(spec, "w") as f:
                json.dump({"args": dict(kw, rank=r), "device": dev}, f)
            log = open(os.path.join(tmp, f"silo_{r}.err"), "w")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "fedml_tpu_torch.cross_silo.silo_main",
                 spec], stdout=subprocess.PIPE, stderr=log, text=True,
                env=env))
        while st.is_alive() and time.perf_counter() < deadline:
            st.join(timeout=1.0)
            dead = [p.returncode for p in procs if p.poll() not in (None, 0)]
            require(not dead, f"cross-silo flagship: a silo exited {dead}")
        require(not st.is_alive(), f"cross-silo flagship: the session did "
                                   f"not finish within {join_s} s")
        require("error" not in box, f"cross-silo flagship server: "
                                    f"{box.get('error')!r}")
        server_launches = launches(cb, fa)
        wall = time.perf_counter() - t_start
        silos = []
        for p in procs:
            out, _ = p.communicate(timeout=120)
            require(p.returncode == 0, f"a silo exited {p.returncode}")
            silos.append(json.loads(out.strip().splitlines()[-1])["silo"])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    result = box["result"]
    times = result["round_times"]
    timed = times[1:]
    # the wall time from the first timed round's broadcast to the end of
    # the last round's close, over the timed rounds (the pieces below
    # leave out the close, the records, selection and the trace)
    s_per_round = (times[-1]["end_s"] - timed[0]["start_s"]) / len(timed)
    pieces_s = sum(t["broadcast_s"] + t["wait_s"] + t["aggregate_s"]
                   + t["eval_s"] for t in timed) / len(timed)
    by_type = WIRE_STATS.snapshot()["by_type"]
    model_types = (str(MyMessage.MSG_TYPE_S2C_INIT_CONFIG),
                   str(MyMessage.MSG_TYPE_S2C_SYNC_MODEL_TO_CLIENT))
    s2c = sum(by_type.get(t, {"bytes": 0})["bytes"] for t in model_types)
    silo_recs = []
    steps_total = 0
    for st_ in sorted(silos, key=lambda x: x["rank"]):
        trains = st_["trainings"]
        steps = sum(t["steps"] for t in trains)
        steps_total += steps
        t_steps = sum(t["steps"] for t in trains if t["round"] >= 1)
        t_s = sum(t["train_s"] for t in trains if t["round"] >= 1)
        b1 = st_["launches"]["fused_block"]
        want = 27 * (st_["warmup_steps"] + st_["replays"])
        require(st_["captures"] == 1 and st_["replays"] == steps
                and b1 == want,
                f"silo {st_['rank']}: {st_['captures']} captures, "
                f"{st_['replays']} replays for {steps} steps, B1 {b1} "
                f"launches (expected {want})")
        require(all(v == 0 for k, v in st_["launches"].items()
                    if k != "fused_block"),
                f"silo {st_['rank']} launched {st_['launches']}")
        silo_recs.append({
            "rank": st_["rank"], "steps": steps,
            "steps_per_round": [t["steps"] for t in trains],
            "ms_per_local_step": 1e3 * t_s / max(t_steps, 1),
            "train_s_per_round": [t["train_s"] for t in trains],
            "captures": st_["captures"], "capture_s": st_["capture_s"],
            "warmup_steps": st_["warmup_steps"], "replays": st_["replays"],
            "b1_launches": b1,
            "hbm_peak_gb": st_.get("peak_allocated_bytes", 0) / 2 ** 30,
            "c2s_bytes": st_.get("c2s_bytes")})
    acc = result["final_test_acc"]
    require(acc is not None and math.isfinite(acc) and all(
        torch.isfinite(v).all().item() for v in result["params"].values()),
        "cross-silo flagship: non-finite params or accuracy")
    eval_batches = result["eval_batches"]
    want = 27 * eval_batches * len(times)
    require(server_launches == {"conv_block": want, "flash_fwd": 0,
                                "flash_dq": 0, "flash_dkv": 0},
            f"cross-silo server launches {server_launches}, expected "
            f"{want} B1 (27 x {eval_batches} eval batches x {len(times)} "
            f"rounds)")
    c2s = sum(r["c2s_bytes"] or 0 for r in silo_recs)
    record = {
        "rounds": len(times), "timed_rounds": len(timed),
        "s_per_round": s_per_round, "rounds_per_hour": 3600.0 / s_per_round,
        "round_times": times,
        "wait_s_per_round": sum(t["wait_s"] for t in timed) / len(timed),
        "aggregate_s_per_round": sum(t["aggregate_s"] for t in timed)
        / len(timed),
        "broadcast_s_per_round": sum(t["broadcast_s"] for t in timed)
        / len(timed),
        "eval_s_per_round": sum(t["eval_s"] for t in timed) / len(timed),
        "other_s_per_round": s_per_round - pieces_s,
        "s2c_model_bytes_per_round": s2c / len(times),
        "c2s_model_bytes_per_round": c2s / len(times),
        "test_acc": acc, "local_steps": steps_total,
        "server_b1_launches": server_launches["conv_block"],
        "server_hbm_peak_gb": ((torch.cuda.max_memory_allocated() - held)
                               / 2 ** 30 if dev != "cpu" else 0.0),
        "silos": silo_recs, "wall_s": wall}
    return record, server_launches, silo_recs


def cross_silo_phase(torch, cb, fa, fedml, tmp, dev="cuda", cpu="cpu"):
    """Phase 16: the cross-silo runtime. Returns (the ``cross_silo``
    record, the silos' B1 launches, the server's)."""
    t_phase = time.perf_counter()
    reset_launches(cb, fa)
    t0 = time.perf_counter()
    checks = cs_checks(torch, fedml, tmp, dev, cpu)
    checks_s = time.perf_counter() - t0
    require(launches(cb, fa) == {"conv_block": 0, "flash_fwd": 0,
                                 "flash_dq": 0, "flash_dkv": 0},
            f"cross-silo checks launched {launches(cb, fa)}")
    t0 = time.perf_counter()
    wire = cs_wire_bench(torch, tmp, dev)
    wire_s = time.perf_counter() - t0
    require(launches(cb, fa) == {"conv_block": 0, "flash_fwd": 0,
                                 "flash_dq": 0, "flash_dkv": 0},
            f"wire bench launched {launches(cb, fa)}")
    full, server_launches, silos = cs_flagship(torch, cb, fa, fedml, tmp,
                                               dev=dev)
    return ({"checks": checks, "checks_s": checks_s, "wire": wire,
             "wire_s": wire_s, "flagship": full,
             "phase_s": time.perf_counter() - t_phase},
            sum(s["b1_launches"] for s in silos),
            server_launches["conv_block"])


def async_trace(torch, agg, pours, k, byzantine, seed=3, scale=0.05):
    """Feed ASYNC_TRACE's scripted uploads to ``agg`` (``pours`` pours of
    ``k``): each upload its dispatch base plus a seeded delta (the
    ``byzantine``-th of a pour x 50), the third pour's first a
    ``topk_qsgd`` blob of its delta. Returns the pours' arrivals."""
    import numpy as np

    from fedml_tpu_torch import prng
    from fedml_tpu_torch.utils import compression as comp
    rng = np.random.RandomState(seed)
    spec = comp.CommCompressionSpec("topk_qsgd", ratio=0.25)
    arrivals = []
    for p in range(pours):
        for i in range(k):
            lag = 0 if i == 0 else int(rng.randint(0, min(p, 5) + 1))
            if p == pours - 1 and i == k - 1:
                lag = p                  # from version 0: past the ring
            v = max(agg.version - lag, 0)
            base = agg.base_for(v)
            delta = (scale * rng.randn(base.shape[0])).astype(np.float32)
            if i == byzantine:
                delta = delta * np.float32(50.0)
            rank, t = 1 + (p * k + i) % 5, float(p * k + i)
            if p == 2 and i == 0:
                blob, _ = comp.ef_compress_vec(delta, None, spec,
                                               prng.PRNGKey(5))
                agg.add_async_upload(rank, comp.decompress_vec(blob), 2.0,
                                     up_version=v, arrival_t=t,
                                     compressed=True)
            else:
                agg.add_async_upload(rank, base + delta, 2.0, up_version=v,
                                     arrival_t=t, compressed=False)
        arrivals.append(agg.pour())
    return arrivals


def async_agg_check(torch, dev="cuda", cpu="cpu"):
    """Phase 17 (a): the async aggregator on ``dev`` against ``cpu`` on
    ASYNC_TRACE, undefended (K 2) and krum-defended (K 4, a byzantine
    row). Returns {leg: record}."""
    import numpy as np

    from fedml_tpu_torch.arguments import Arguments
    from fedml_tpu_torch.cross_silo.server.async_server import \
        AsyncFedMLAggregator
    gen = torch.Generator().manual_seed(0)
    init = {"Dense_0.weight": 0.1 * torch.randn(10, 8, generator=gen),
            "Dense_0.bias": 0.1 * torch.randn(10, generator=gen)}
    out = {}
    for leg, knobs, k, byz in (("plain", {}, 2, None),
                               ("krum", ASYNC_TRACE_KRUM, 4, 1)):
        aggs, arrivals = [], []
        for d in (dev, cpu):
            agg = AsyncFedMLAggregator(
                Arguments(**ASYNC_TRACE, async_buffer_k=k, **knobs), init,
                device=d)
            arrivals.append(async_trace(torch, agg, ASYNC_TRACE_POURS, k,
                                        byz))
            aggs.append(agg)
        card, ref = aggs
        order = [[(a["client"], a["staleness"]) for a in p]
                 for p in arrivals[0]]
        require(order == [[(a["client"], a["staleness"]) for a in p]
                          for p in arrivals[1]],
                f"async aggregator ({leg}): card and CPU pour differently")
        ratio = _house_ratio(torch, card.global_params, ref.global_params)
        require(ratio <= 1.0 and card.version == ASYNC_TRACE_POURS,
                f"async aggregator ({leg}): card vs CPU at {ratio:.3f} of "
                f"HOUSE_TOL, version {card.version}")
        verdicts = all(np.array_equal(getattr(card.silo_stats, key),
                                      getattr(ref.silo_stats, key))
                       for key in ("incl_obs", "excl_obs"))
        require(verdicts, f"async aggregator ({leg}): verdicts differ")
        stal = [s for p in order for _, s in p]
        require(max(stal) >= 5, f"async aggregator ({leg}): staleness "
                                f"{stal} never past the ring")
        rec = {"of_tolerance": ratio, "pours": card.version,
               "staleness": stal, "params_device":
                   str(next(iter(card.global_params.values())).device)}
        if knobs:
            rec["excluded"] = float(card.silo_stats.excl_obs.sum())
            rec["ef_carried"] = sorted(card._ef_carry)
            require(rec["excluded"] > 0, "krum excluded no row")
        else:
            rec["bitwise"] = all(torch.equal(
                card.global_params[n].cpu(), v)
                for n, v in ref.global_params.items())
            require(rec["bitwise"], "undefended async pours: card and CPU "
                                    "differ (host arithmetic)")
        out[leg] = rec
    return out


@contextlib.contextmanager
def storage_dir(path):
    """The object store's root (``FEDML_TPU_STORAGE_DIR``) set to ``path``
    in this process for the block."""
    prev = os.environ.get("FEDML_TPU_STORAGE_DIR")
    os.environ["FEDML_TPU_STORAGE_DIR"] = path
    try:
        yield path
    finally:
        if prev is None:
            os.environ.pop("FEDML_TPU_STORAGE_DIR", None)
        else:
            os.environ["FEDML_TPU_STORAGE_DIR"] = prev


def _store_objects(root):
    files = [os.path.join(root, f) for f in os.listdir(root)
             if not f.endswith(".tmp")]
    return len(files), sum(os.path.getsize(f) for f in files)


def cs_trpc_session(torch, cfg, dev, tmp, join_s=180.0):
    """``cfg`` over TRPC, one process per rank (``silo_main``: the server
    and each silo on ``dev``). Returns the server's params (read back from
    its ``params_out``) and its record."""
    import numpy as np

    from fedml_tpu_torch.core.distributed.communication.message import \
        loads_tree
    n = cfg["client_num_per_round"]
    kw = dict(cfg, backend="TRPC", trpc_master_addr="127.0.0.1",
              trpc_master_port=free_port_base(1), training_type="cross_silo",
              data_cache_dir=tmp, enable_tracking=False)
    out = os.path.join(tmp, "trpc_params.msgpack")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs, logs = [], []
    try:
        for r in range(n + 1):
            spec = os.path.join(tmp, f"trpc_{r}.json")
            with open(spec, "w") as f:
                json.dump({"args": dict(kw, rank=r), "device": dev,
                           "role": "server" if r == 0 else "client",
                           "params_out": out}, f)
            log = open(os.path.join(tmp, f"trpc_{r}.err"), "w")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "fedml_tpu_torch.cross_silo.silo_main",
                 spec], stdout=subprocess.PIPE, stderr=log, text=True,
                env=env))
        outs = [p.communicate(timeout=join_s)[0] for p in procs]
        codes = [p.returncode for p in procs]
        require(codes == [0] * (n + 1), f"TRPC session: ranks exited "
                                        f"{codes}")
    except subprocess.TimeoutExpired:
        raise SmokeFailure(f"TRPC session did not finish within {join_s} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    with open(out, "rb") as f:
        params = {k: torch.from_numpy(np.array(v))
                  for k, v in loads_tree(f.read()).items()}
    return params, json.loads(outs[0].strip().splitlines()[-1])["server"]


def cs_async_checks(torch, tmp, dev="cuda", cpu="cpu"):
    """Phase 17 (a). Returns {check: record}."""
    out = {"aggregator_card_vs_cpu": async_agg_check(torch, dev, cpu)}
    inproc, _ = cs_session(CS_LR, dev, "INPROC")
    store = os.path.join(tmp, "cs_store_lr")
    os.makedirs(store, exist_ok=True)
    with storage_dir(store):
        ps, _ = cs_session(CS_LR, dev, "PUBSUB_STORAGE")
    same = all(torch.equal(ps.result["params"][k], v)
               for k, v in inproc.result["params"].items())
    objects, nbytes = _store_objects(store)
    require(same, "cross-silo LR session: PUBSUB_STORAGE params differ "
                  "from INPROC's")
    require(objects > 0, "PUBSUB_STORAGE offloaded no payload")
    out["pubsub_storage_vs_inproc_bitwise"] = {
        "bitwise": same, "store_objects": objects, "store_bytes": nbytes}
    t0 = time.perf_counter()
    params, server = cs_trpc_session(torch, CS_LR, dev, tmp)
    same = all(torch.equal(params[k], v.cpu())
               for k, v in inproc.result["params"].items())
    require(same, "cross-silo LR session: TRPC params differ from "
                  "INPROC's")
    out["trpc_vs_inproc_bitwise"] = {
        "bitwise": same, "rounds": len(server["history"]),
        "wall_s": time.perf_counter() - t0}
    cfg = dict(CS_LR, **CS_LINK, round_mode="async_buffered",
               async_buffer_k=2, async_pour_timeout_s=1.0,
               comm_round=CS_ASYNC_LR_POURS)
    t0 = time.perf_counter()
    server, _ = cs_session(cfg, dev, "INPROC")
    c = server.aggregator.buffer.counters
    pours = server.chaos_ledger.pours()
    stal = [a["staleness"] for p in pours for a in p["injected"]["arrivals"]]
    require(len(server.result["history"]) == CS_ASYNC_LR_POURS
            and len(pours) == CS_ASYNC_LR_POURS
            and c["added"] == c["poured"] + c["buffered"]
            and sum(p["observed"]["poured"] for p in pours) == c["poured"]
            and stal and max(stal) >= 1,
            f"async LR session under link faults: "
            f"{len(server.result['history'])} pours, ledger {c}, "
            f"staleness {stal}")
    out["async_link_faults"] = {
        "pours": len(pours), "ledger": c, "staleness_max": max(stal),
        "final_test_acc": server.result["final_test_acc"],
        "wall_s": time.perf_counter() - t0}
    return out


def cs_async_flagship(torch, cb, fa, fedml, tmp, cfg=CS_ASYNC_FULL,
                      dev="cuda", join_s=CS_JOIN_S, warm=CS_ASYNC_WARM):
    """Phase 17 (b): ``cfg`` as a buffered-async session over
    PUBSUB_STORAGE: the broker and the server (``run_cross_silo_server``)
    in this process, each silo a ``silo_main`` process on ``dev``, the
    object store under ``tmp``. Returns (the record, the server's
    launches, each silo's record)."""
    import threading

    from fedml_tpu_torch.core.distributed.communication.pubsub import \
        PubSubBroker

    n = cfg["client_num_per_round"]
    store = os.path.join(tmp, "cs_store_full")
    os.makedirs(store, exist_ok=True)
    broker = PubSubBroker()
    kw = dict(cfg, backend="PUBSUB_STORAGE", pubsub_broker_port=broker.port,
              data_cache_dir=tmp, enable_tracking=False, run_id="async17")
    procs, logs, box = [], [], {}
    t_start = time.perf_counter()
    reset_launches(cb, fa)

    def serve():
        try:
            runner = fedml.cross_silo_runner("server", device=dev, **kw)
            box["manager"] = runner.runner.manager
            box["result"] = runner.run()
        except BaseException as e:   # reported below
            box["error"] = e

    # the store's root for the server, whose transport reads it when it is
    # built (the silos get it in their specs)
    with storage_dir(store):
        st = threading.Thread(target=serve, daemon=True)
        st.start()
        env = dict(os.environ, OMP_NUM_THREADS=str(max(
            1, (os.cpu_count() or 1) // (n + 1))))
        deadline = time.perf_counter() + join_s
        try:
            for r in range(1, n + 1):
                spec = os.path.join(tmp, f"async_silo_{r}.json")
                with open(spec, "w") as f:
                    json.dump({"args": dict(kw, rank=r), "device": dev,
                               "storage_dir": store}, f)
                log = open(os.path.join(tmp, f"async_silo_{r}.err"), "w")
                logs.append(log)
                procs.append(subprocess.Popen(
                    [sys.executable, "-m",
                     "fedml_tpu_torch.cross_silo.silo_main", spec],
                    stdout=subprocess.PIPE, stderr=log, text=True, env=env))
            while st.is_alive() and time.perf_counter() < deadline:
                st.join(timeout=1.0)
                dead = [p.returncode for p in procs
                        if p.poll() not in (None, 0)]
                require(not dead, f"async cross-silo flagship: a silo "
                                  f"exited {dead}")
            require(not st.is_alive(), f"async cross-silo flagship: the "
                                       f"session did not finish within "
                                       f"{join_s} s")
            require("error" not in box, f"async cross-silo flagship "
                                        f"server: {box.get('error')!r}")
            server_launches = launches(cb, fa)
            wall = time.perf_counter() - t_start
            silos = []
            for p in procs:
                out, _ = p.communicate(timeout=120)
                require(p.returncode == 0, f"a silo exited {p.returncode}")
                silos.append(
                    json.loads(out.strip().splitlines()[-1])["silo"])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for log in logs:
                log.close()
            broker.stop()
    result = box["result"]
    times = result["round_times"]
    timed = times[warm:]
    require(len(times) == cfg["comm_round"] and timed,
            f"async flagship: {len(times)} pours")
    # wall time from the first timed pour's start (the previous pour's
    # end) to the last pour's end, over the timed pours
    s_per_pour = (times[-1]["end_s"] - timed[0]["start_s"]) / len(timed)
    pieces_s = sum(t["wait_s"] + t["aggregate_s"] + t["eval_s"]
                   + t["broadcast_s"] for t in timed) / len(timed)
    history = result["history"]
    k = cfg["async_buffer_k"]
    require(all(h["poured"] == k for h in history),
            f"async flagship: pours of {[h['poured'] for h in history]} "
            f"(a partial pour)")
    silo_recs, steps_total = [], 0
    for st_ in sorted(silos, key=lambda x: x["rank"]):
        trains = st_["trainings"]
        steps = sum(t["steps"] for t in trains)
        steps_total += steps
        b1 = st_["launches"]["fused_block"]
        want = 27 * (st_["warmup_steps"] + st_["replays"])
        require(st_["captures"] == 1 and st_["replays"] == steps
                and b1 == want,
                f"async silo {st_['rank']}: {st_['captures']} captures, "
                f"{st_['replays']} replays for {steps} steps, B1 {b1} "
                f"launches (expected {want})")
        require(all(v == 0 for n_, v in st_["launches"].items()
                    if n_ != "fused_block"),
                f"async silo {st_['rank']} launched {st_['launches']}")
        later = trains[1:]
        t_steps = sum(t["steps"] for t in later)
        silo_recs.append({
            "rank": st_["rank"], "trainings": len(trains), "steps": steps,
            "steps_per_training": [t["steps"] for t in trains],
            "ms_per_local_step": (1e3 * sum(t["train_s"] for t in later)
                                  / t_steps if t_steps else None),
            "captures": st_["captures"], "capture_s": st_["capture_s"],
            "warmup_steps": st_["warmup_steps"], "replays": st_["replays"],
            "b1_launches": b1, "c2s_bytes": st_.get("c2s_bytes"),
            "hbm_peak_gb": st_.get("peak_allocated_bytes", 0) / 2 ** 30})
    eval_batches = result["eval_batches"]
    evals = sum("test_acc" in h for h in history)
    want = 27 * eval_batches * evals
    require(server_launches == {"conv_block": want, "flash_fwd": 0,
                                "flash_dq": 0, "flash_dkv": 0},
            f"async cross-silo server launches {server_launches}, expected "
            f"{want} B1 (27 x {eval_batches} eval batches x {evals} evals)")
    acc = result["final_test_acc"]
    require(acc is not None and math.isfinite(acc) and all(
        torch.isfinite(v).all().item() for v in result["params"].values()),
        "async cross-silo flagship: non-finite params or accuracy")
    manager = box["manager"]
    ledger = manager.aggregator.buffer.counters
    pours = manager.chaos_ledger.pours()
    require(ledger["added"] == ledger["poured"] + ledger["buffered"]
            and len(pours) == len(times),
            f"async flagship: buffer ledger {ledger}, {len(pours)} pours")
    stal = {}
    for p in pours:
        for a in p["injected"]["arrivals"]:
            stal[str(a["staleness"])] = stal.get(str(a["staleness"]), 0) + 1
    objects, nbytes = _store_objects(store)
    return ({"pours": len(times), "timed_pours": len(timed), "k": k,
             "s_per_pour": s_per_pour,
             "updates_per_hour": 3600.0 * k / s_per_pour,
             "pours_per_hour": 3600.0 / s_per_pour,
             "wait_s_per_pour": sum(t["wait_s"] for t in timed) / len(timed),
             "aggregate_s_per_pour": sum(t["aggregate_s"] for t in timed)
             / len(timed),
             "eval_s_per_pour": sum(t["eval_s"] for t in timed) / len(timed),
             "broadcast_s_per_pour": sum(t["broadcast_s"] for t in timed)
             / len(timed),
             "other_s_per_pour": s_per_pour - pieces_s,
             "pour_times": times, "buffer_ledger": ledger,
             "staleness_histogram": stal,
             "staleness_mean": [h["staleness_mean"] for h in history],
             "store_objects": objects, "store_bytes": nbytes,
             "test_acc": acc, "local_steps": steps_total,
             "server_b1_launches": server_launches["conv_block"],
             "silos": silo_recs, "wall_s": wall},
            server_launches, silo_recs)


def async_cross_silo_phase(torch, cb, fa, fedml, tmp, dev="cuda",
                           cpu="cpu"):
    """Phase 17: the async cross-silo runtime and the PUBSUB / TRPC
    transports. Returns (the ``async_cross_silo`` record, the silos' B1
    launches, the server's)."""
    t_phase = time.perf_counter()
    reset_launches(cb, fa)
    t0 = time.perf_counter()
    checks = cs_async_checks(torch, tmp, dev, cpu)
    checks_s = time.perf_counter() - t0
    require(launches(cb, fa) == {"conv_block": 0, "flash_fwd": 0,
                                 "flash_dq": 0, "flash_dkv": 0},
            f"async cross-silo checks launched {launches(cb, fa)}")
    full, server_launches, silos = cs_async_flagship(torch, cb, fa, fedml,
                                                     tmp, dev=dev)
    return ({"checks": checks, "checks_s": checks_s, "flagship": full,
             "phase_s": time.perf_counter() - t_phase},
            sum(s["b1_launches"] for s in silos),
            server_launches["conv_block"])


def _parts(cfg, **extra):
    """``(args, fed, bundle)`` of the port for ``cfg``."""
    from fedml_tpu_torch import data, model
    from fedml_tpu_torch.arguments import Arguments
    args = Arguments(**cfg, enable_tracking=False, **extra)
    fed, output_dim = data.load(args)
    return args, fed, model.create(args, output_dim, fed.input_shape)


def gossip_session(cfg, dev, blobs=None):
    """``cfg`` as an INPROC gossip session on ``dev``; ``blobs`` (a dict)
    collects every compressed N2N blob under its key (node and round)."""
    import numpy as np

    from fedml_tpu_torch.cross_silo import decentralized as D
    args, fed, bundle = _parts(cfg, training_type="cross_silo")
    orig = D.encode_update

    def spy(vec, **kw):
        enc = orig(vec, **kw)
        blobs[np.asarray(kw["rng"]).tobytes()] = enc.payload
        return enc

    if blobs is not None:
        D.encode_update = spy
    try:
        result = D.run_gossip_inproc(args, fed, bundle, device=dev)
    finally:
        D.encode_update = orig
    require(result is not None, f"gossip session on {dev} did not finish")
    return result


def _blob_agreement(card, cpu):
    """Card blobs against CPU blobs: (all bitwise, kept indices and levels
    bitwise, worst relative scale difference)."""
    import numpy as np
    require(sorted(card) == sorted(cpu) and card,
            f"gossip blobs: {len(card)} on the card, {len(cpu)} on the CPU")
    bitwise, selection, scale = True, True, 0.0
    for key, a in card.items():
        b = cpu[key]
        for k in a:
            same = np.asarray(a[k]).tobytes() == np.asarray(b[k]).tobytes()
            bitwise &= same
            if k == "s":
                scale = max(scale, abs(float(a[k]) - float(b[k]))
                            / max(abs(float(b[k])), 1e-30))
            else:
                selection &= same
    return bitwise, selection, scale


def scenario_checks(torch, dev="cuda", cpu="cpu"):
    """Phase 18 (a). Returns {check: record}."""
    from fedml_tpu_torch.cross_silo.hierarchical import \
        run_hierarchical_cross_silo_inproc
    from fedml_tpu_torch.cross_silo.horizontal.runner import \
        run_cross_silo_inproc
    from fedml_tpu_torch.cross_silo.split_learning import run_splitnn_inproc
    from fedml_tpu_torch.cross_silo.vertical import run_vfl_inproc
    from fedml_tpu_torch.runner import FedMLRunner

    out = {}
    card, ref = gossip_session(GOSSIP_LR, dev), gossip_session(GOSSIP_LR, cpu)
    ratio = _house_ratio(torch, card["params"], ref["params"])
    require(ratio <= 1.0 and card["final_test_acc"] == ref["final_test_acc"],
            f"gossip LR session: card vs CPU at {ratio:.3f} of HOUSE_TOL, "
            f"acc {card['final_test_acc']} vs {ref['final_test_acc']}")
    out["gossip_card_vs_cpu"] = {
        "of_tolerance": ratio, "test_acc": card["final_test_acc"],
        "consensus_dist": [card["consensus_dist"], ref["consensus_dist"]]}
    cfg = dict(GOSSIP_LR, **GOSSIP_CC)
    blobs_card, blobs_cpu = {}, {}
    card = gossip_session(cfg, dev, blobs_card)
    ref = gossip_session(cfg, cpu, blobs_cpu)
    bitwise, selection, scale = _blob_agreement(blobs_card, blobs_cpu)
    ratio = _house_ratio(torch, card["params"], ref["params"])
    require(selection and scale <= GOSSIP_SCALE_RTOL and ratio <= 1.0,
            f"compressed gossip: indices and levels equal {selection}, "
            f"scale {scale:.2e} apart, params at {ratio:.3f} of HOUSE_TOL")
    out["gossip_compressed_card_vs_cpu"] = {
        "blobs": len(blobs_card), "bitwise": bitwise,
        "indices_and_levels_bitwise": selection,
        "scale_max_rel_diff": scale, "of_tolerance": ratio}

    def sp(cfg, d):
        args, fed, bundle = _parts(cfg)
        r = FedMLRunner(args, device=d, dataset=fed, model=bundle).run()
        return r, fed
    card, _ = sp(GOSSIP_LR, dev)
    ref, _ = sp(GOSSIP_LR, cpu)
    ratio = _house_ratio(torch, card["params"], ref["params"])
    require(ratio <= 1.0, f"SP decentralized loop: card vs CPU at "
                          f"{ratio:.3f} of HOUSE_TOL")
    out["sp_decentralized_card_vs_cpu"] = {
        "of_tolerance": ratio, "test_acc": card["final_test_acc"]}

    split = dict(MULTIPARTY, federated_optimizer="split_nn")
    sim, fed = sp(split, dev)
    sessions = {}
    for d in (dev, cpu):
        args, fed, _ = _parts(split, training_type="cross_silo")
        sessions[d] = run_splitnn_inproc(args, fed, device=d)
    r_sim = _house_ratio(torch, sessions[dev]["params"]["top"],
                         sim["params"]["top"])
    r_cpu = _house_ratio(torch, sessions[dev]["params"]["top"],
                         sessions[cpu]["params"]["top"])
    accs = [[h["test_acc"] for h in r["history"]]
            for r in (sessions[dev], sim, sessions[cpu])]
    require(r_sim <= 1.0 and r_cpu <= 1.0 and accs[0] == accs[1] == accs[2],
            f"split learning: session vs SP at {r_sim:.3f}, vs CPU at "
            f"{r_cpu:.3f} of HOUSE_TOL, accuracies {accs}")
    out["split_learning"] = {"session_vs_sp": r_sim,
                             "session_card_vs_cpu": r_cpu,
                             "test_acc": accs[0]}

    vfl = dict(MULTIPARTY, federated_optimizer="vfl")
    sim, _ = sp(vfl, dev)
    for d in (dev, cpu):
        args, fed, _ = _parts(vfl, training_type="cross_silo")
        sessions[d] = run_vfl_inproc(args, fed, device=d)
    r_sim = max(_house_ratio(torch, a, b) for a, b in
                zip(sessions[dev]["party_params"], sim["params"]))
    r_cpu = max(_house_ratio(torch, a, b) for a, b in
                zip(sessions[dev]["party_params"],
                    sessions[cpu]["party_params"]))
    accs = [[h["test_acc"] for h in r["history"]]
            for r in (sessions[dev], sim, sessions[cpu])]
    require(r_sim <= 1.0 and r_cpu <= 1.0 and accs[0] == accs[1] == accs[2],
            f"vertical FL: session vs SP at {r_sim:.3f}, vs CPU at "
            f"{r_cpu:.3f} of HOUSE_TOL, accuracies {accs}")
    out["vertical_fl"] = {"session_vs_sp": r_sim,
                          "session_card_vs_cpu": r_cpu, "test_acc": accs[0]}

    runs = {}
    for scenario in ("hierarchical", "horizontal"):
        cfg = dict(CS_LR, comm_round=2)
        args, fed, bundle = _parts(cfg, training_type="cross_silo",
                                   scenario=scenario)
        run = (run_hierarchical_cross_silo_inproc if scenario ==
               "hierarchical" else run_cross_silo_inproc)
        runs[scenario] = run(args, fed, bundle, device=dev)
    same = all(torch.equal(runs["hierarchical"]["params"][k], v)
               for k, v in runs["horizontal"]["params"].items())
    require(same, "hierarchical session (1-rank silos) differs from the "
                  "horizontal session")
    out["hierarchical_vs_horizontal_bitwise"] = same
    return out


def gossip_wire_leg(tmp, dev="cuda"):
    """Phase 18 (c): bench.py's gossip leg on ``dev``, dense then
    ``topk_qsgd``: N2N model-bearing bytes per round off the WireStats
    ledger (the in-proc broker encodes every message)."""
    from fedml_tpu_torch.core.distributed.communication.message import \
        WIRE_STATS
    from fedml_tpu_torch.cross_silo.decentralized import GossipMsg

    rounds = GOSSIP_WIRE["comm_round"]

    def session(**kw):
        WIRE_STATS.reset()
        t0 = time.perf_counter()
        result = gossip_session(dict(GOSSIP_WIRE, data_cache_dir=tmp, **kw),
                                dev)
        wall = time.perf_counter() - t0
        by_type = WIRE_STATS.snapshot()["by_type"]
        rec = by_type.get(GossipMsg.N2N_PARAMS,
                          by_type.get(str(GossipMsg.N2N_PARAMS),
                                      {"bytes": 0}))
        return {"bytes_per_round": rec["bytes"] / rounds,
                "final_acc": result["final_test_acc"],
                "consensus_dist": result["consensus_dist"], "wall_s": wall}

    off = session()
    on = session(gossip_compression="topk_qsgd", comm_compression_ratio=0.1)
    return {"bytes_per_round": on["bytes_per_round"],
            "dense_bytes_per_round": off["bytes_per_round"],
            "reduction_vs_dense": (off["bytes_per_round"]
                                   / on["bytes_per_round"]
                                   if on["bytes_per_round"] else None),
            "final_acc": on["final_acc"], "dense_final_acc": off["final_acc"],
            "consensus_dist": on["consensus_dist"],
            "dense_consensus_dist": off["consensus_dist"],
            "wall_s": on["wall_s"], "dense_wall_s": off["wall_s"]}


def gossip_flagship(torch, cb, fa, tmp, cfg=GOSSIP_FULL, dev="cuda",
                    join_s=CS_JOIN_S):
    """Phase 18 (b): ``cfg`` as a gossip session over TCP, each node a
    ``silo_main`` process (role ``gossip``) on ``dev``. Returns (the
    record, each node's record)."""
    n = cfg["client_num_in_total"]
    base = free_port_base(n)
    kw = dict(cfg, backend="TCP", tcp_base_port=base, data_cache_dir=tmp,
              enable_tracking=False)
    procs, logs = [], []
    t_start = time.perf_counter()
    reset_launches(cb, fa)
    env = dict(os.environ, OMP_NUM_THREADS=str(max(
        1, (os.cpu_count() or 1) // n)))
    try:
        for r in range(n):
            spec = os.path.join(tmp, f"gossip_{r}.json")
            with open(spec, "w") as f:
                json.dump({"args": dict(kw, rank=r), "device": dev,
                           "role": "gossip"}, f)
            log = open(os.path.join(tmp, f"gossip_{r}.err"), "w")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "fedml_tpu_torch.cross_silo.silo_main",
                 spec], stdout=subprocess.PIPE, stderr=log, text=True,
                env=env))
        nodes = []
        deadline = time.perf_counter() + join_s
        for r, p in enumerate(procs):
            left = max(deadline - time.perf_counter(), 1.0)
            try:
                out, _ = p.communicate(timeout=left)
            except subprocess.TimeoutExpired:
                raise SmokeFailure(f"gossip flagship: a node did not finish "
                                   f"within {join_s} s")
            if p.returncode != 0:
                logs[r].flush()
                with open(logs[r].name) as f:
                    tail = f.read()[-3000:]
                raise SmokeFailure(f"gossip node {r} exited {p.returncode}:"
                                   f"\n{tail}")
            nodes.append(json.loads(out.strip().splitlines()[-1])["gossip"])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    wall = time.perf_counter() - t_start
    require(launches(cb, fa) == {"conv_block": 0, "flash_fwd": 0,
                                 "flash_dq": 0, "flash_dkv": 0},
            f"the gossip flagship launched {launches(cb, fa)} in this "
            f"process")
    nodes.sort(key=lambda x: x["rank"])
    result = nodes[0]["result"]
    eval_batches = nodes[0]["eval_batches"]
    rounds = cfg["comm_round"]
    timed = range(rounds - GOSSIP_FULL_TIMED, rounds)
    # the wall time of the timed rounds: the first node's start of the
    # first timed round to the last node's end of the last
    s_per_round = (max(nd["rounds"][rounds - 1]["end_t"] for nd in nodes)
                   - min(nd["rounds"][timed[0]]["start_t"] for nd in nodes)
                   ) / len(timed)
    node_recs, n2n = [], 0
    for nd in nodes:
        steps = sum(t["steps"] for t in nd["trainings"])
        t_steps = sum(nd["rounds"][r]["steps"] for r in timed)
        t_s = sum(nd["rounds"][r]["train_s"] for r in timed)
        # node 0 trains and evaluates in one process: its counters are
        # read just before its evaluation and just after it
        if nd["rank"] == 0:
            b1 = nd["launches_before_eval"]["fused_block"]
            evals = nd["eval_launches"]["fused_block"]
            require(evals == 27 * eval_batches
                    and nd["launches"]["fused_block"] == b1 + evals,
                    f"gossip node 0: B1 {evals} launches in its evaluation "
                    f"(expected 27 x {eval_batches} batches), "
                    f"{nd['launches']['fused_block']} in all, {b1} before "
                    f"it")
        else:
            b1, evals = nd["launches"]["fused_block"], 0
        want = 27 * (nd["warmup_steps"] + nd["replays"])
        require(nd["captures"] == 1 and nd["replays"] == steps
                and b1 == want,
                f"gossip node {nd['rank']}: {nd['captures']} captures, "
                f"{nd['replays']} replays for {steps} steps, B1 {b1} "
                f"training launches (expected {want})")
        require(all(v == 0 for k, v in nd["launches"].items()
                    if k != "fused_block"),
                f"gossip node {nd['rank']} launched {nd['launches']}")
        n2n += nd["n2n_bytes"]
        node_recs.append({
            "rank": nd["rank"], "steps": steps,
            "steps_per_round": [r["steps"] for r in nd["rounds"]],
            "ms_per_local_step": 1e3 * t_s / max(t_steps, 1),
            "train_s_per_round": [r["train_s"] for r in nd["rounds"]],
            "send_s_per_round": [r["send_s"] for r in nd["rounds"]],
            "wait_s_per_round": [r["wait_s"] for r in nd["rounds"]],
            "decode_s_per_round": [r["decode_s"] for r in nd["rounds"]],
            "mix_s_per_round": [r["mix_s"] for r in nd["rounds"]],
            "captures": nd["captures"], "capture_s": nd["capture_s"],
            "warmup_steps": nd["warmup_steps"], "replays": nd["replays"],
            "b1_launches": b1, "b1_eval_launches": evals,
            "hbm_peak_gb": nd.get("peak_allocated_bytes", 0) / 2 ** 30,
            "n2n_bytes": nd["n2n_bytes"]})
    acc, consensus = result["final_test_acc"], result["consensus_dist"]
    require(acc is not None and math.isfinite(acc)
            and math.isfinite(consensus),
            f"gossip flagship: accuracy {acc}, consensus {consensus}")
    record = {
        "rounds": rounds, "timed_rounds": len(timed),
        "s_per_round": s_per_round, "rounds_per_hour": 3600.0 / s_per_round,
        "n2n_bytes_per_round": n2n / rounds,
        "consensus_dist": consensus, "test_acc": acc,
        "eval_batches": eval_batches,
        "b1_launches_nodes": sum(r["b1_launches"] for r in node_recs),
        "b1_launches_eval": node_recs[0]["b1_eval_launches"],
        "nodes": node_recs, "wall_s": wall}
    return record, node_recs


def gossip_phase(torch, cb, fa, tmp, dev="cuda", cpu="cpu"):
    """Phase 18: the other cross-silo scenarios. Returns the ``gossip``
    record (its checks, the flagship session)."""
    t_phase = time.perf_counter()
    reset_launches(cb, fa)
    t0 = time.perf_counter()
    checks = scenario_checks(torch, dev, cpu)
    checks_s = time.perf_counter() - t0
    require(launches(cb, fa) == {"conv_block": 0, "flash_fwd": 0,
                                 "flash_dq": 0, "flash_dkv": 0},
            f"scenario checks launched {launches(cb, fa)}")
    full, _ = gossip_flagship(torch, cb, fa, tmp, dev=dev)
    return {"checks": checks, "checks_s": checks_s, "flagship": full,
            "phase_s": time.perf_counter() - t_phase}


def bench_truncated_normal(key, shape):
    """``jax.random.truncated_normal(key, -2, 2, shape)`` in float32, on
    the host, as flax's ``lecun_normal`` draws it: ``sqrt(2) *
    erf_inv(u)`` for ``u`` uniform on ``[erf(-sqrt(2)), erf(sqrt(2)))``
    (the correctly rounded float32 values, which are XLA's at these
    bounds), clipped inside the bounds; ``erf_inv`` is the port's prng's
    (XLA's single-precision polynomial)."""
    import math

    import numpy as np

    from fedml_tpu_torch import prng
    lo, hi = np.float32(-2.0), np.float32(2.0)
    sqrt2 = np.float32(np.sqrt(2.0))
    a = np.float32(math.erf(float(lo / sqrt2)))
    b = np.float32(math.erf(float(hi / sqrt2)))
    u = prng.uniform(key, int(np.prod(shape)), minval=a, maxval=b)
    out = (sqrt2 * prng._erf_inv(prng._NumpyOps, u)).astype(np.float32)
    return np.clip(out, np.nextafter(lo, np.float32(np.inf)),
                   np.nextafter(hi, np.float32(-np.inf))).reshape(shape)


def bench_lr_init(seed, fan_in, fan_out):
    """The JAX package's LR init for ``random_seed`` ``seed``, as bench.py
    draws it (``bundle.init(split(PRNGKey(seed))[0])``: flax's Dense_0,
    a lecun_normal kernel and a zero bias), through the port's prng and
    flax's key derivation, as a state dict of host arrays."""
    import numpy as np

    from fedml_tpu_torch import prng
    from fedml_tpu_torch.interop import flax_to_state_dict
    from fedml_tpu_torch.model.dropout import scope_salt
    # make_rng("params")'s first call in scope Dense_0
    key = prng.fold_in(prng.split(prng.PRNGKey(seed))[0],
                       scope_salt("Dense_0", 1))
    std = np.float32(np.sqrt(np.float32(1.0 / fan_in))) / np.float32(
        0.87962566103423978)
    kernel = bench_truncated_normal(key, (fan_in, fan_out)) * std
    return flax_to_state_dict({"Dense_0": {
        "kernel": kernel, "bias": np.zeros(fan_out, np.float32)}})


def secagg_wire_leg(torch, tmp, dev="cuda", cfg=SECAGG_WIRE,
                    bits=SECAGG_WIRE_BITS, target=CS_WIRE_TARGET,
                    init=None, gate=True):
    """Phase 16 (b)'s SecAgg leg: bench.py's _secagg_wire_leg through the
    port's modules on ``dev`` (the local steps and the dense leg's
    quantize / dequantize on the card, the masks and the lanes on the
    host), from ``init`` (a state dict) or the bench's own init
    (:func:`bench_lr_init`): rounds to 90 % depend on the draw. With
    ``gate`` the JAX bench's acceptance is required. Returns the bench's
    record and each leg's wall seconds."""
    import numpy as np

    from fedml_tpu_torch import prng
    from fedml_tpu_torch.core.algframe.client_trainer import \
        make_trainer_spec
    from fedml_tpu_torch.core.collectives import FlatLayout
    from fedml_tpu_torch.core.mpc import P, dequantize, expand_mask, quantize
    from fedml_tpu_torch.core.mpc.field_ops import lanes, to_uint32
    from fedml_tpu_torch.core.wire import (field_encode, lane_dequantize_sum,
                                           plan_for, suggest_scale)
    from fedml_tpu_torch.cross_silo.client.trainer import SiloTrainer
    from fedml_tpu_torch.cross_silo.horizontal.runner import _make_eval_fn
    from fedml_tpu_torch.optimizers.registry import create_optimizer

    p = int(P)
    k_n, rounds = cfg["client_num_per_round"], cfg["comm_round"]
    device = torch.device(dev)
    args, fed, bundle = _parts(dict(cfg, data_cache_dir=tmp),
                               training_type="cross_silo")
    spec = make_trainer_spec(fed, bundle)
    trainer = SiloTrainer(args, fed, bundle, spec,
                          create_optimizer(args, spec), device)
    eval_fn = _make_eval_fn(spec, fed, device)
    fan_out, fan_in = trainer.params_template["Dense_0.weight"].shape
    if init is None:
        init = bench_lr_init(cfg["random_seed"], fan_in, fan_out)
    params0 = {k: torch.as_tensor(v).to(device) for k, v in init.items()}
    layout = FlatLayout.of(params0)
    d = layout.size

    def local_vec(global_p, cidx, rnd):
        # the bench's key, fold_in(PRNGKey(17 + silo), round)
        out, _, _ = trainer.train(global_p, cidx, rnd, key=prng.fold_in(
            prng.PRNGKey(17 + cidx), rnd))
        return layout.flatten(out).float()

    def leg(use_lanes):
        plan = plan_for(bits, k_n) if use_lanes else None
        scale = suggest_scale(4.0, plan) if plan else None
        residuals = [None] * k_n
        global_p = params0
        plen = plan.packed_len(d) if plan else d
        hit, acc, exact = None, 0.0, True
        t0 = time.perf_counter()
        for rnd in range(rounds):
            qs = []
            for k in range(k_n):
                vec = local_vec(global_p, k, rnd)
                if plan:
                    packed, residuals[k] = field_encode(
                        vec.cpu().numpy(), scale, plan, residuals[k],
                        np.random.default_rng((k + 1) * 1000003 + rnd))
                    qs.append(packed.astype(np.uint64))
                else:
                    qs.append(to_uint32(quantize(vec)).astype(np.uint64))
            # +s_ij for i < j, -s_ij for i > j: the sum cancels mod p
            masked = np.zeros(plen, np.uint64)
            plain = np.zeros(plen, np.uint64)
            for i in range(k_n):
                m = qs[i] % p
                for j in range(k_n):
                    if i == j:
                        continue
                    seed = (rnd << 16) ^ (min(i, j) << 8) ^ max(i, j)
                    s = expand_mask(seed, plen).astype(np.uint64)
                    m = (m + s) % p if i < j else (m + p - s) % p
                masked = (masked + m) % p
                plain = (plain + qs[i]) % p
            exact = exact and bool(np.array_equal(masked, plain))
            if plan:
                ssum = lane_dequantize_sum(masked.astype(np.uint32), k_n,
                                           scale, plan, d)
                avg = torch.from_numpy(ssum / k_n)
                # the scale's running average, as SecAggServerManager
                per_client = float(np.abs(ssum).max()) / k_n
                scale = 0.5 * scale + 0.5 * suggest_scale(
                    max(2.0 * per_client, 1e-8), plan)
            else:
                avg = dequantize(lanes(masked, device))[:d] / k_n
            global_p = layout.unflatten(avg.to(device, torch.float32),
                                        like=params0)
            acc = float(eval_fn(global_p)["test_acc"])
            if hit is None and acc >= target:
                hit = rnd
        return {"bytes_per_round": float(plen * 4 * k_n),
                "rounds_to_target": hit, "final_acc": acc,
                "mask_sum_bit_exact": exact,
                "wall_s": time.perf_counter() - t0}

    dense = leg(use_lanes=False)
    lanes_leg = leg(use_lanes=True)
    rec = {
        "bytes_per_round": lanes_leg["bytes_per_round"],
        "dense_field_bytes_per_round": dense["bytes_per_round"],
        "reduction_vs_dense_field": (dense["bytes_per_round"]
                                     / lanes_leg["bytes_per_round"]),
        "rounds_to_target": lanes_leg["rounds_to_target"],
        "dense_field_rounds_to_target": dense["rounds_to_target"],
        "final_acc": lanes_leg["final_acc"],
        "dense_field_final_acc": dense["final_acc"],
        "mask_sum_bit_exact": bool(lanes_leg["mask_sum_bit_exact"]
                                   and dense["mask_sum_bit_exact"]),
        "bits": bits, "k_max": k_n, "target_acc": target,
        "wall_s": lanes_leg["wall_s"], "dense_field_wall_s": dense["wall_s"]}
    hits = (rec["rounds_to_target"], rec["dense_field_rounds_to_target"])
    require(not gate or rec["mask_sum_bit_exact"]
            and rec["reduction_vs_dense_field"] >= 4
            and None not in hits and abs(hits[0] - hits[1]) <= 2,
            f"SecAgg wire leg: {rec}")
    return rec


def field_checks(torch, d, dev="cuda", cpu="cpu"):
    """Phase 19 (a): core/mpc's field math on ``dev`` against ``cpu`` and
    an exact integer reference, bitwise, over ``d`` coordinates (the
    flagship's parameter count). Returns what was checked."""
    import numpy as np

    from fedml_tpu_torch import prng
    from fedml_tpu_torch.core import mpc
    from fedml_tpu_torch.core.mpc.field_ops import lanes, to_uint32

    p = int(mpc.P)
    rng = np.random.RandomState(19)
    edge = np.asarray(FIELD_EDGE, np.uint32)
    a = np.concatenate([np.repeat(edge, len(edge)), rng.randint(
        0, p, FIELD_PAIRS).astype(np.uint32)])
    b = np.concatenate([np.tile(edge, len(edge)), rng.randint(
        0, p, FIELD_PAIRS).astype(np.uint32)])
    a64, b64 = a.astype(np.uint64), b.astype(np.uint64)
    ref = {"ff_add": (a64 + b64) % p, "ff_sub": (a64 + p - b64) % p,
           "ff_neg": (p - a64) % p, "ff_mul": (a64 * b64) % p}

    def both(fn, *xs):
        """``fn`` on the card and on the CPU: (card, CPU) host results."""
        return [fn(*(x.to(where) if torch.is_tensor(x) else lanes(x, where)
                     for x in xs)).cpu() for where in (dev, cpu)]

    for op, want in ref.items():
        xs = (a,) if op == "ff_neg" else (a, b)
        card, host = both(getattr(mpc, op), *xs)
        require(np.array_equal(to_uint32(card), to_uint32(host))
                and np.array_equal(to_uint32(host), want.astype(np.uint32)),
                f"field {op}: card, CPU and the integer reference differ")
    # quantize over D: normals x 8, ties at half a quantum, past the clip
    x = (rng.randn(d) * 8).astype(np.float32)
    half = np.float32(2.0 ** -17)
    special = np.asarray([1, 3, 5, -1, -3, -5, 7, -7], np.float32) * half
    x[:8] = special
    x[8:16] = [2.0 ** 14, -(2.0 ** 14), 1e9, -1e9, np.inf, -np.inf, 0.0,
               -0.0]
    card, host = both(mpc.quantize, torch.from_numpy(x))
    s = np.clip(np.round(x * np.float32(65536.0)), -2.0 ** 29,
                2.0 ** 29).astype(np.int64)
    want_q = np.where(s >= 0, s, p + s).astype(np.uint32)
    require(np.array_equal(to_uint32(card), to_uint32(host))
            and np.array_equal(to_uint32(host), want_q),
            "quantize: card, CPU and the reference differ")
    card_dq, host_dq = both(mpc.dequantize, card)
    fq = rng.randint(0, p, d).astype(np.uint32)
    card_f, host_f = both(mpc.dequantize, fq)
    for got_card, got_host, q in ((card_dq, host_dq, want_q),
                                  (card_f, host_f, fq)):
        q64 = q.astype(np.int64)
        signed = np.where(q64 > p // 2, q64 - p, q64).astype(np.int32)
        want_f = signed.astype(np.float32) / np.float32(65536.0)
        require(np.array_equal(got_card.numpy().view(np.uint32),
                               got_host.numpy().view(np.uint32))
                and np.array_equal(got_host.numpy().view(np.uint32),
                                   want_f.view(np.uint32)),
                "dequantize: card, CPU and the reference differ")
    for k in (4, 64):
        m = rng.randint(0, p, size=(k, d)).astype(np.uint32)
        card, host = both(mpc.sum_mod_p, m)
        want = m.astype(np.uint64).sum(axis=0) % p
        require(np.array_equal(to_uint32(card), to_uint32(host))
                and np.array_equal(to_uint32(host), want.astype(np.uint32)),
                f"sum_mod_p over [{k}, {d}]: card, CPU and the integer "
                f"reference differ")
    key = prng.PRNGKey(19)
    card = mpc.ff_random(key, (d,), dev).cpu()
    host = mpc.ff_random(key, (d,), cpu)
    b0, b1 = prng.threefry2x32(key, np.zeros(d, np.uint32),
                               np.arange(d, dtype=np.uint32))
    bits = (b0 ^ b1).astype(np.uint64)
    folded = (bits >> 31) + (bits & p)
    folded = np.where(folded >= p, folded - p, folded).astype(np.uint32)
    require(np.array_equal(to_uint32(card), to_uint32(host))
            and np.array_equal(to_uint32(host), folded),
            "ff_random: card, CPU and the host threefry differ")
    return {"pairs": int(len(a)), "d": int(d), "sum_mod_p_k": [4, 64]}


class CutSilo:
    """A secure session's silo trainer (a ``SiloTrainer``, as the
    sessions' ``client_factory`` hook hands it over; or a cross-device
    torch engine's, which also passes its round key) whose local training
    stops after ``steps`` steps (``work_scale``, as the chaos straggler
    cuts it); ``trained`` keeps each training's received params, new
    params and sample count, on the trainer's device."""

    def __init__(self, trainer, steps):
        self.trainer, self.steps, self.trained = trainer, steps, []

    def __getattr__(self, name):
        return getattr(self.trainer, name)

    def train(self, params, client_idx, round_idx, **kw):
        real = int(self.trainer.batch_real[client_idx].sum())
        new, n, metrics = self.trainer.train(
            params, client_idx, round_idx,
            work_scale=(self.steps - 0.5) / real, **kw)
        self.trained.append((params, new, n))
        return new, n, metrics


def secagg_flagship_sessions(torch, cb, fa, parts, dev="cuda",
                             steps=SECAGG_STEPS):
    """Phase 19 (b): the SA and LSA INPROC sessions at ``parts``' width
    (the flagship's: ``(args, fed, bundle)``) on ``dev``, every silo's
    training cut to ``steps`` steps. Returns the record and the SA
    session's silo trainings ``[(received, new, n)]``."""
    import copy

    from fedml_tpu_torch.cross_silo.lightsecagg import (LSAClientManager,
                                                        run_lsa_inproc)
    from fedml_tpu_torch.cross_silo.secagg import (SecAggClientManager,
                                                   run_secagg_inproc)

    args0, fed, bundle = parts
    k = int(args0.client_num_per_round)
    rounds = int(args0.comm_round)
    n_eval = int(fed.test["x"].shape[0])
    cuda = torch.device(dev).type == "cuda"
    out, params, trained = {}, {}, None
    for fo, run, manager in (("SA", run_secagg_inproc, SecAggClientManager),
                             ("LSA", run_lsa_inproc, LSAClientManager)):
        args = copy.copy(args0)
        args.federated_optimizer = fo
        silos = []

        def factory(rank, a, trainer, manager=manager, silos=silos):
            silos.append(CutSilo(trainer, steps))
            return manager(a, silos[-1], rank=rank, size=k + 1,
                           backend="INPROC")

        reset_launches(cb, fa)
        t0 = time.perf_counter()
        res = run(args, fed, bundle, client_factory=factory, device=dev)
        wall = time.perf_counter() - t0
        b1 = launches(cb, fa)
        require(res is not None and "error" not in res
                and len(res["history"]) == rounds
                and math.isfinite(res["history"][-1]["test_loss"]),
                f"{fo} flagship session: {res and res.get('error')}")
        stats = [s.program_stats() for s in silos]
        silo_steps = [sum(r["steps"] for r in s.log) for s in silos]
        forwards = (sum(st["warmup_steps"] + st["replays"] for st in stats)
                    + n_eval * rounds)
        if cuda:
            require(len(silos) == k
                    and all(st["captures"] == 1 for st in stats)
                    and silo_steps == [steps * rounds] * k
                    and [st["replays"] for st in stats] == silo_steps
                    and b1["conv_block"] == 27 * forwards
                    and b1["flash_fwd"] == 0,
                    f"{fo} flagship session: {stats}, steps {silo_steps}, "
                    f"launches {b1} (B1 27 x (warm-up + replays + "
                    f"{n_eval * rounds} eval batches) expected)")
        # plain FedAvg of the same silos' deltas, in float64, with
        # quantize's clip of n x delta at +-2^29 quanta (the JAX package
        # clips there too)
        done = [t for s in silos for t in s.trained]
        wsum = float(sum(n for _, _, n in done))
        quanta = rounds * k * 2.0 ** -16 / wsum
        worst, clipped = 0.0, 0
        for name, got in res["params"].items():
            acc = torch.zeros(got.shape, dtype=torch.float64,
                              device=got.device)
            for received, new, n in done:
                nd = (new[name].double() - received[name].double()) * n
                clipped += int((nd.abs() > 2.0 ** 13).sum())
                acc += nd.clamp(-2.0 ** 13, 2.0 ** 13)
            ref = done[0][0][name].double() + acc / wsum
            bound = HOUSE_TOL[1] + quanta + HOUSE_TOL[0] * ref.abs()
            worst = max(worst, float(((got.double() - ref).abs()
                                      / bound).max()))
        require(worst <= 1.0, f"{fo} flagship session vs plain FedAvg of "
                              f"its silos' deltas: {worst:.3f} of the "
                              f"tolerance")
        params[fo] = res["params"]
        if fo == "SA":
            trained = done
        out[fo] = {"wall_s": wall, "within_tolerance": worst,
                   "quanta": quanta, "clipped_coordinates": clipped,
                   "samples": [n for _, _, n in done],
                   "steps_per_silo": silo_steps,
                   "train_s": [r["train_s"] for s in silos for r in s.log],
                   "captures": sum(st["captures"] for st in stats),
                   "capture_s": [st["capture_s"] for st in stats],
                   "warmup_steps": sum(st["warmup_steps"] for st in stats),
                   "replays": sum(st["replays"] for st in stats),
                   "eval_batches": n_eval * rounds,
                   "b1_launches": b1["conv_block"],
                   "test_acc": res["final_test_acc"]}
    out["sa_vs_lsa_max_abs"] = max(
        float((params["SA"][k_] - params["LSA"][k_]).abs().max())
        for k_ in params["SA"])
    return out, trained


def secagg_algebra(torch, trained, dev="cuda"):
    """Phase 19 (c): the masking algebra over the silo trainings
    ``trained`` (``[(received, new, n)]`` on ``dev``): each n x delta
    quantized on the card, masked on the host; unmasked with 0 and 1
    silo dropped, and LightSecAgg's coding over the same D. Returns the
    record."""
    import numpy as np

    from fedml_tpu_torch.core.mpc import (P, SecAggClient,
                                          aggregate_encoded,
                                          decode_aggregate_mask,
                                          mask_encoding, quantize,
                                          secagg_unmask, sum_mod_p)
    from fedml_tpu_torch.core.mpc.field_ops import lanes, to_uint32
    from fedml_tpu_torch.cross_silo.wire import flat_delta

    p = int(P)
    n = len(trained)
    device = torch.device(dev)
    cuda = device.type == "cuda"
    qs, q_ms = [], []
    for received, new, n_i in trained:
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        vec = flat_delta(new, received)
        qs.append(to_uint32(quantize(vec * float(n_i))))   # waits
        q_ms.append((time.perf_counter() - t0) * 1e3)
        require(bool(torch.isfinite(vec).all()), "non-finite silo delta")
    d = len(qs[0])
    t = n // 2 + 1
    clients = [SecAggClient(i, n, t, seed=100 + i) for i in range(n)]
    publics = {c.cid: c.public_key for c in clients}
    for c in clients:
        c.receive_publics(publics)
    shares = [c.make_shares() for c in clients]
    seed_sh = {i: [shares[i][j][0] for j in range(n)] for i in range(n)}
    key_sh = {i: [shares[i][j][1] for j in range(n)] for i in range(n)}
    masked, mask_s = [], []
    for i, c in enumerate(clients):
        t0 = time.perf_counter()
        masked.append(((qs[i].astype(np.uint64) + c.mask_total(d)) % p)
                      .astype(np.uint32))
        mask_s.append(time.perf_counter() - t0)
    unmask_s, lsa = {}, {}
    privacy_t = 1                  # LSA's defaults (cross_silo/lightsecagg:
    threshold = max(n - 1, 2)      # lsa_params, lsa_privacy_t,
    split_t = max(threshold - privacy_t, 1)   # lsa_threshold)
    d_pad = -(-d // split_t) * split_t
    zs = [np.random.RandomState(200 + i).randint(0, p, d_pad).astype(
        np.uint64) for i in range(n)]
    t0 = time.perf_counter()
    enc = [mask_encoding(zs[i], n, privacy_t, split_t,
                         np.random.RandomState(300 + i)) for i in range(n)]
    lsa["encode_s_per_client"] = (time.perf_counter() - t0) / n
    for drop in ((), (n - 1,)):
        surv = [i for i in range(n) if i not in drop]
        plain = to_uint32(sum_mod_p(torch.stack(
            [lanes(qs[i], device) for i in surv])))
        total = np.zeros(d, np.uint64)
        for i in surv:
            total = (total + masked[i]) % p
        t0 = time.perf_counter()
        un = secagg_unmask(total.astype(np.uint32), surv, list(drop),
                           {i: seed_sh[i][:t] for i in surv},
                           {i: key_sh[i][:t] for i in drop}, publics, d)
        unmask_s[len(drop)] = time.perf_counter() - t0
        require(np.array_equal(un, plain),
                f"secagg_unmask with {len(drop)} dropped differs from the "
                f"survivors' plain quantized sum")
        need = split_t + privacy_t
        t0 = time.perf_counter()
        resp = [aggregate_encoded([enc[i][j] for i in surv]) for j in surv]
        z_sum = decode_aggregate_mask(resp[:need], surv[:need], n,
                                      privacy_t, split_t, d_pad)
        lsa[f"decode_s_{len(drop)}_dropped"] = time.perf_counter() - t0
        want_z = np.zeros(d_pad, np.uint64)
        lsa_total = np.zeros(d_pad, np.uint64)
        for i in surv:
            want_z = (want_z + zs[i]) % p
            lsa_total = (lsa_total + (np.pad(qs[i].astype(np.uint64),
                                             (0, d_pad - d)) + zs[i]) % p) % p
        lsa_un = (lsa_total + p - z_sum % p) % p
        require(np.array_equal(z_sum % p, want_z)
                and np.array_equal(lsa_un[:d].astype(np.uint32), plain),
                f"LightSecAgg with {len(drop)} dropped: the aggregate mask "
                f"or the unmasked sum differs")
    return {"d": int(d), "silos": n, "threshold": t,
            "delta_quantize_ms_per_client": float(np.mean(q_ms)),
            "delta_quantize_ms": q_ms,
            "mask_s_per_client": float(np.mean(mask_s)), "mask_s": mask_s,
            "unmask_s_0_dropped": unmask_s[0],
            "unmask_s_1_dropped": unmask_s[1],
            "masks_expanded_per_round": n * n + n + (n - 1) * 2,
            "lsa": dict(lsa, split_t=split_t, privacy_t=privacy_t)}


def secagg_refusals(torch, dev="cuda", cfg=SECAGG_LR):
    """On a host without ``cryptography``: SA and LSA, server and client,
    must fail at build with the ModuleNotFoundError that names it."""
    import fedml_tpu_torch
    from fedml_tpu_torch.core.distributed.communication.inproc import \
        InProcBroker
    for fo in ("SA", "LSA"):
        for role in ("server", "client"):
            try:
                fedml_tpu_torch.cross_silo_runner(
                    role, device=dev, backend="INPROC", rank=1,
                    inproc_broker=InProcBroker(), federated_optimizer=fo,
                    enable_tracking=False, **cfg)
            except ModuleNotFoundError as e:
                require((e.name or "").split(".")[0] == "cryptography",
                        f"{fo} {role}: {e!r} does not name cryptography")
            else:
                raise SmokeFailure(f"{fo} {role} built without the "
                                   f"cryptography package")


def secagg_sessions(torch, dev="cuda", cpu="cpu", cfg=SECAGG_LR):
    """Phase 19 (d): the SA and LSA INPROC sessions of ``cfg`` on ``dev``
    against ``cpu``. Returns the record."""
    import numpy as np

    from fedml_tpu_torch.cross_silo.lightsecagg import run_lsa_inproc
    from fedml_tpu_torch.cross_silo.secagg import run_secagg_inproc
    out = {}
    for fo, run in (("SA", run_secagg_inproc), ("LSA", run_lsa_inproc)):
        res = {}
        for where in (dev, cpu):
            args, fed, bundle = _parts(dict(cfg, federated_optimizer=fo),
                                       training_type="cross_silo")
            t0 = time.perf_counter()
            res[where] = run(args, fed, bundle, device=where)
            require(res[where] is not None and "error" not in res[where],
                    f"{fo} session on {where}: {res[where]}")
            res[where]["wall_s"] = time.perf_counter() - t0
        n = np.asarray(fed.train.num_samples)[:cfg["client_num_per_round"]]
        quanta = cfg["comm_round"] * len(n) * 2.0 ** -16 / float(n.sum())
        worst = 0.0
        for k, v in res[cpu]["params"].items():
            got = res[dev]["params"][k].detach().cpu().double()
            ref = v.detach().cpu().double()
            bound = HOUSE_TOL[1] + quanta + HOUSE_TOL[0] * ref.abs()
            worst = max(worst, float(((got - ref).abs() / bound).max()))
        require(worst <= 1.0, f"{fo} session: card vs CPU {worst:.3f} of "
                              f"the tolerance")
        out[fo] = {"within_tolerance": worst, "quanta": quanta,
                   "test_acc": res[dev]["final_test_acc"],
                   "cpu_test_acc": res[cpu]["final_test_acc"],
                   "wall_s": res[dev]["wall_s"],
                   "cpu_wall_s": res[cpu]["wall_s"]}
    return out


def secagg_phase(torch, cb, fa, tmp, dev="cuda", cpu="cpu",
                 cfg=SECAGG_FULL):
    """Phase 19: secure aggregation. Returns the ``secure_aggregation``
    record (the field checks; the sessions at ``cfg``'s width and the
    masking algebra over their silos' deltas; the sessions on
    SECAGG_LR, card vs CPU)."""
    from fedml_tpu_torch.core.collectives import FlatLayout
    t_phase = time.perf_counter()
    parts = _parts(dict(cfg, data_cache_dir=tmp), training_type="cross_silo")
    d = FlatLayout.of(parts[2].init(torch.Generator().manual_seed(0),
                                    "cpu")).size
    reset_launches(cb, fa)
    t0 = time.perf_counter()
    field = field_checks(torch, d, dev, cpu)
    field["s"] = time.perf_counter() - t0
    try:
        import cryptography  # noqa: F401
    except ModuleNotFoundError:
        secagg_refusals(torch, dev)
        absent = "cpu_only: cryptography absent on this host"
        return {"field": field, "flagship_sessions": absent,
                "algebra": absent, "sessions": absent,
                "phase_s": time.perf_counter() - t_phase}
    t0 = time.perf_counter()
    flagship, trained = secagg_flagship_sessions(torch, cb, fa, parts, dev)
    flagship["s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    algebra = secagg_algebra(torch, trained, dev)
    algebra["s"] = time.perf_counter() - t0
    del trained
    reset_launches(cb, fa)
    t0 = time.perf_counter()
    sessions = secagg_sessions(torch, dev, cpu)
    require(launches(cb, fa) == {"conv_block": 0, "flash_fwd": 0,
                                 "flash_dq": 0, "flash_dkv": 0},
            f"the secure-aggregation sessions launched {launches(cb, fa)}")
    return {"field": field, "flagship_sessions": flagship,
            "algebra": algebra, "sessions": sessions,
            "sessions_s": time.perf_counter() - t0,
            "phase_s": time.perf_counter() - t_phase}


# -- phase 20: the compute plane ---------------------------------------------

def _dims(shape: str):
    """``"bf16[32,32,32,16]"`` -> ``(32, 32, 32, 16)``."""
    return tuple(int(d) for d in shape[shape.index("[") + 1:-1].split(",")
                 if d)


def roofline_flagship(torch, cb, fa, records, card):
    """Phase 20 (a) and (c): the flagship's step through the GPU engine's
    seam under ``obs_roofline``, then a width change for the forensics.
    Returns the record and the round's launches."""
    from torch.utils.flop_counter import FlopCounterMode, flop_registry

    from fedml_tpu_torch import data, model
    from fedml_tpu_torch.arguments import Arguments
    from fedml_tpu_torch.core.algframe.local_training import batch_real_of
    from fedml_tpu_torch.core.algframe.types import ClientData, TrainHyper
    from fedml_tpu_torch.core.kernels.cost import block_cost
    from fedml_tpu_torch.core.obs import roofline, schema
    from fedml_tpu_torch.runner import FedMLRunner

    args = Arguments(**ROOFLINE_PATH)
    fed, n_classes = data.load(args)
    sim = FedMLRunner(args, dataset=fed, model=model.create(
        args, n_classes, fed.input_shape)).runner
    hyper = TrainHyper(learning_rate=ROOFLINE_PATH["learning_rate"],
                       epochs=1)
    require(sim._roofline.enabled, "roofline: obs_roofline did not reach "
                                   "the engine")
    sim.capture_step(hyper)
    (prog,) = sim.programs.values()
    reset_launches(cb, fa)
    analysed0 = cb.fused_block.analysed
    steps0, replays0 = prog.steps, prog.replays
    t0 = time.perf_counter()
    sim.run_round(0, hyper)
    torch.cuda.synchronize()
    round_s = time.perf_counter() - t0
    b1 = launches(cb, fa)
    steps = prog.steps - steps0
    require(prog.replays - replays0 == steps and
            b1["conv_block"] == 27 * steps,
            f"roofline round: B1 launched {b1['conv_block']} times for "
            f"{steps} replayed steps (27 each expected); the capture's "
            f"launches are counted apart")
    recs = [r for r in records if r["kind"] == "roofline"]
    require(len(recs) == 1 and recs[0]["program"] == "round",
            f"roofline: {len(recs)} records for the round")
    rec = recs[0]
    errs = schema.validate_record(rec)
    require(not errs, f"roofline record against the schema: {errs}")
    require(not rec["static_only"] and rec["attributed_share"] == 1.0
            and {o["mult"] for o in rec["ops"] if o["op"] != "(other)"}
            == {steps},
            f"roofline record: static {rec['static_only']}, attributed "
            f"{rec['attributed_share']}, mult != {steps}")
    # the step's rows, uncapped: B1 and the registry ops
    rows = roofline.capture_rows(prog.analysis_step)
    require(cb.fused_block.analysed - analysed0 == 2 * 27,
            f"roofline: {cb.fused_block.analysed - analysed0} B1 launches "
            f"in the two captures, 54 expected")
    kern = [r for r in rows if r.opcode == "kernel"]
    geoms = {}
    for r in kern:
        n, h, _, cin = _dims(r.operands[0])
        cout, ho = _dims(r.out)[3], _dims(r.out)[1]
        s = h // ho
        geoms[(h, cin, cout, s)] = geoms.get((h, cin, cout, s), 0) + 1
        want = block_cost(n, h, cin, cout, s, 2)
        require(r.name.startswith("fused_block") and n == BATCH
                and (r.bytes, r.flops) == want,
                f"roofline B1 row {r.name} {r.operands} -> {r.out}: "
                f"{(r.bytes, r.flops)} != block_cost {want}")
    require(geoms == dict(FLAGSHIP),
            f"roofline: B1 rows by geometry {geoms}, expected "
            f"{dict(FLAGSHIP)} (27 per forward)")
    per_step = sum(r.flops for r in rows)
    require(math.isclose(rec["total_flops"], per_step * steps,
                         rel_tol=1e-9),
            f"roofline: the record's {rec['total_flops']} FLOPs != "
            f"{steps} x the step's {per_step}")
    names = {p.__name__ for p in flop_registry if hasattr(p, "__name__")}
    reg_flops = sum(r.flops for r in rows if r.opcode in names)
    with FlopCounterMode(display=False) as fc:
        prog.analysis_step()
    require(reg_flops == fc.get_total_flops(),
            f"roofline: conv + matmul rows {reg_flops} FLOPs != "
            f"FlopCounterMode's {fc.get_total_flops()}")
    # the step's measured time: replays of its CUDA graph, CUDA events
    for _ in range(3):
        prog.graph.replay()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(ROOFLINE_STEP_REPLAYS):
        prog.graph.replay()
    end.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / ROOFLINE_STEP_REPLAYS
    predicted_ms = rec["predicted_s"] / steps * 1e3

    # (c) forensics: the same engine at batch 16
    n_fore = len([r for r in records if r["kind"] == "recompile"])
    t = sim.train
    c = t.x.shape[0]

    def half(a):
        return a.reshape((c, -1, BATCH // 2) + tuple(a.shape[3:]))
    sim.train = ClientData(half(t.x), half(t.y), half(t.mask),
                           t.num_samples)
    sim.batch_real = batch_real_of(sim.train.mask.cpu().numpy())
    sim.run_round(1, hyper)
    torch.cuda.synchronize()
    fore = [r for r in records if r["kind"] == "recompile"]
    changed = {} if len(fore) != 1 else {
        ch["arg"]: (ch["was"], ch["now"]) for ch in fore[0]["changed"]}
    x_change = changed.get("['train']['x']")
    require(n_fore == 0 and len(fore) == 1 and x_change is not None
            and x_change[0].endswith(f",{BATCH},32,32,3]")
            and x_change[1].endswith(f",{BATCH // 2},32,32,3]")
            and not schema.validate_record(fore[0]),
            f"roofline forensics: {n_fore} records before, {fore}")
    return {
        "program": rec["program"], "steps": steps, "round_s": round_s,
        "ops": len(rows), "b1_rows": len(kern), "b1_geometries": {
            "x".join(map(str, k)): v for k, v in geoms.items()},
        "step_flops": per_step, "registry_flops": reg_flops,
        "flop_counter_mode_flops": fc.get_total_flops(),
        "total_flops": rec["total_flops"], "total_bytes":
        rec["total_bytes"], "predicted_ms_per_step": predicted_ms,
        "measured_ms_per_step": step_ms,
        "predicted_over_measured": predicted_ms / step_ms,
        "predicted_mfu": rec["predicted_mfu"],
        "memory_bound_share": rec["memory_bound_share"],
        "compute_bound_share": rec["compute_bound_share"],
        "top_ops": [{k: o[k] for k in ("name", "op", "operands", "out",
                                       "time_s", "bound")}
                    for o in rec["ops"][:8]],
        "recompile": fore[0], "card": card}, b1


def roofline_llm(torch, llm, cb, fa, records, Arguments, card):
    """Phase 20 (b) and (d): the 111M hot loop's SGD step (B2-B4 rows
    against ``attention_cost``), the serving decode and prefill programs
    through ``DecodeScheduler(roofline=True)`` (one record per program and
    signature), and the cost of the always-on signature at the 64-slot
    decode step."""
    from torch.func import functional_call

    from fedml_tpu_torch.core.kernels.cost import attention_cost
    from fedml_tpu_torch.core.obs import roofline, schema
    from fedml_tpu_torch.llm.data import BOS, SEP
    from fedml_tpu_torch.serving.batch import DecodeScheduler

    cfg = llm.LLMConfig(**HOT_LOOP)
    mod, params = llm.init_llm(cfg, torch.Generator().manual_seed(0))
    mod.to("cuda")
    params = {k: v.to("cuda") for k, v in params.items()}
    spec = llm.CausalLMTrainer(
        lambda p, x, train=False: functional_call(mod, p, (x,)))
    gen = torch.Generator().manual_seed(1)
    seq = cfg.max_seq_len
    batch = {"x": torch.randint(0, cfg.vocab_size, (HOT_BATCH, seq),
                                generator=gen).cuda(),
             "y": torch.randint(0, cfg.vocab_size, (HOT_BATCH, seq),
                                generator=gen).cuda(),
             "mask": torch.ones(HOT_BATCH).cuda()}

    def hot_step(p, b):
        leaves = {k: v.detach().requires_grad_() for k, v in p.items()}
        loss, _ = spec.loss(leaves, b)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        with torch.no_grad():
            return {k: v - 1e-3 * g for (k, v), g in zip(p.items(), grads)}

    reset_launches(cb, fa)
    an0 = {fn.__name__: fn.analysed for fn in (fa.flash_fwd, fa.flash_dq,
                                               fa.flash_dkv)}
    t0 = time.perf_counter()
    rows = roofline.capture_rows(hot_step, (params, batch))
    hot_s = time.perf_counter() - t0
    layers = HOT_LOOP["num_layers"]
    shape = (HOT_BATCH, seq, HOT_LOOP["num_heads"],
             HOT_LOOP["hidden_size"] // HOT_LOOP["num_heads"], False)
    kern = {}
    for r in (r for r in rows if r.opcode == "kernel"):
        name = r.name.split(".")[0]
        kern[name] = kern.get(name, 0) + 1
        want = attention_cost(shape, 2, {"flash_fwd": "fwd",
                                         "flash_dq": "dq",
                                         "flash_dkv": "dkv"}[name])
        require((r.bytes, r.flops) == want and
                _dims(r.operands[0]) == shape[:4],
                f"roofline hot step row {r.name} {r.operands}: "
                f"{(r.bytes, r.flops)} != attention_cost {want}")
    analysed = {fn.__name__: fn.analysed - an0[fn.__name__]
                for fn in (fa.flash_fwd, fa.flash_dq, fa.flash_dkv)}
    require(kern == {"flash_fwd": layers, "flash_dq": layers,
                     "flash_dkv": layers} == analysed
            and launches(cb, fa) == {"conv_block": 0, "flash_fwd": 0,
                                     "flash_dq": 0, "flash_dkv": 0},
            f"roofline hot step: kernel rows {kern}, analysed {analysed} "
            f"(each {layers} expected), counted launches "
            f"{launches(cb, fa)} (0 expected)")
    hot = roofline.record_from_rows("llm_hot_step", rows, device="cuda")
    errs = schema.validate_record(dict(hot, kind="roofline", ts=0.0,
                                       run_id="chip"))
    require(not errs, f"hot step record against the schema: {errs}")
    del params, mod, batch
    torch.cuda.empty_cache()

    # the serving programs on the FedLLM main path's model, 64 slots
    bundle, tok = llm.build_llm_bundle(Arguments(**LLM_MAIN_PATH))
    bundle.to("cuda")
    n0 = len([r for r in records if r["kind"] == "roofline"])
    sched = DecodeScheduler(bundle.module, bundle.cfg, bundle.base_params,
                            None, slots=SERVE_BATCH["slots"],
                            block_size=SERVE_BATCH["block_size"],
                            prefill_chunk=SERVE_BATCH["prefill_chunk"],
                            device="cuda", roofline=True)
    for i in range(SERVE_BATCH["slots"]):
        sched.admit([BOS] + tok.encode(SERVE_PROMPTS[i % len(
            SERVE_PROMPTS)]) + [SEP], max_new_tokens=SERVE_MAX_NEW)
    sched.step()      # the decode programs' captures: timed apart
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ROOFLINE_DECODE_STEPS):
        sched.step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / ROOFLINE_DECODE_STEPS * 1e3
    recs = [r for r in records if r["kind"] == "roofline"][n0:]
    per = {}
    for r in recs:
        per[r["program"]] = per.get(r["program"], 0) + 1
    sigs = {p: len(s) for p, s in sched._roofline._captured.items()}
    require(per.get("llm_decode_step") == 1
            and per.get("llm_prefill_chunk") == sigs["llm_prefill_chunk"]
            and per == sigs
            and all(not schema.validate_record(r) for r in recs),
            f"serving roofline: records per program {per}, signatures "
            f"{sigs} (one record each, decode 1 over "
            f"{ROOFLINE_DECODE_STEPS + 1} steps)")
    dec = roofline.report("llm_decode_step")
    pre = roofline.report("llm_prefill_chunk")
    # (d) the always-on path: the decode step's signature
    args = (sched.params, sched._stack(), sched._kp, sched._vp,
            sched._dev(sched._tables), sched._dev(sched._pos),
            sched._dev(sched._active), sched._dev(sched._aidx).long(),
            sched._dev(sched._last), *sched._sampling(
                sched._temp, sched._seed, sched._pos + 1))
    roofline.dispatch_signature(args)
    n = 2000
    t0 = time.perf_counter()
    for _ in range(n):
        roofline.dispatch_signature(args)
    sig_us = (time.perf_counter() - t0) / n * 1e6
    return {
        "hot_step": {k: hot[k] for k in (
            "total_flops", "total_bytes", "predicted_s", "predicted_mfu",
            "memory_bound_share", "attributed_share")},
        "hot_step_kernel_rows": kern, "hot_step_ops": len(rows),
        "hot_step_capture_s": hot_s,
        "serving_records": per, "serving_signatures": sigs,
        "decode_step": {k: dec[k] for k in (
            "total_flops", "total_bytes", "predicted_s",
            "memory_bound_share")},
        "prefill_chunk": {k: pre[k] for k in (
            "total_flops", "total_bytes", "predicted_s",
            "memory_bound_share")},
        "decode_step_ms_64_slots": step_ms,
        "signature_us_per_dispatch": sig_us,
        "signature_share_of_step": sig_us / 1e3 / step_ms,
        "signature_leaves": len(roofline.dispatch_signature(args)),
        "card": card}


def roofline_phase(torch, llm, cb, fa, Arguments, card):
    """Phase 20: the compute plane on the card (records through the obs
    sink into a list)."""
    from fedml_tpu_torch.core.obs import sink
    records = []
    sink.set_sink(records.append)
    try:
        t0 = time.perf_counter()
        flag, b1 = roofline_flagship(torch, cb, fa, records, card)
        lm = roofline_llm(torch, llm, cb, fa, records, Arguments, card)
    finally:
        sink.set_sink(None)
    return {"phase_s": time.perf_counter() - t0, "flagship": flag,
            "llm": lm, "card": card}, b1


# -- phase 21: cross-device --------------------------------------------------

def cd_session(torch, cb, fa, parts, cache, dev="cuda", engines=None,
               steps=None, **extra):
    """One in-proc cross-device session of ``parts`` (``(args, fed,
    bundle)``) on ``dev``, built as ``run_cross_device_inproc`` builds it,
    every torch device's training cut to ``steps`` steps when given.
    Returns (result, server, devices, launches, wall seconds)."""
    import copy

    from fedml_tpu_torch.cross_device import (build_device_client,
                                              build_device_server)
    from fedml_tpu_torch.cross_silo import run_inproc_session

    args, fed, bundle = parts
    args = copy.copy(args)
    args.model_file_cache_dir = cache
    for k, v in extra.items():
        setattr(args, k, v)
    n = int(args.client_num_per_round)
    engs = engines or [None] * n
    made = []

    def build():
        made.append(build_device_server(args, fed, bundle,
                                        backend="INPROC", device=dev))
        for i in range(n):
            d = build_device_client(args, fed, copy.deepcopy(bundle),
                                    device_id=i + 1, backend="INPROC",
                                    engine=engs[i], device=dev)
            if steps is not None and d.trainer is not None:
                d.trainer = CutSilo(d.trainer, steps)
            made.append(d)
        return made

    reset_launches(cb, fa)
    t0 = time.perf_counter()
    res = run_inproc_session(args, build, join_timeout_s=CS_JOIN_S)
    wall = time.perf_counter() - t0
    require(res is not None and len(res["history"]) == int(args.comm_round),
            f"cross-device session ({dev}): {res and res.get('history')}")
    return res, made[0], made[1:], launches(cb, fa), wall


def _upload_state(path, dev):
    """A dense upload artifact as a float32 state dict on ``dev``."""
    from fedml_tpu_torch.interop import flax_to_state_dict
    from fedml_tpu_torch.serving import load_model
    import numpy as np
    import torch
    return {k: torch.tensor(np.asarray(v, np.float32), device=dev)
            for k, v in flax_to_state_dict(load_model(path)).items()}


def cd_flagship(torch, cb, fa, parts, tmp, wire):
    """Phase 21 (a) / (b): 4 ResNet-56 devices (torch engine, B1, 2 steps
    each) and the server on the card, 1 round; the model against a
    float32 weighted mean of the uploads computed apart (and with
    ``wire``, each upload's decode on the card against the CPU's)."""
    import numpy as np

    from fedml_tpu_torch.core.collectives import tree_flatten_to_vector
    from fedml_tpu_torch.core.wire import decode_update
    from fedml_tpu_torch.serving import load_model

    tag = "compressed" if wire else "dense"
    cache = os.path.join(tmp, f"cd_{tag}")
    res, server, devices, b1, wall = cd_session(
        torch, cb, fa, parts, cache, steps=CD_STEPS, **wire)
    _, fed, _ = parts
    n_eval = int(fed.test["x"].shape[0])
    stats = [d.trainer.program_stats() for d in devices]
    forwards = (sum(s["warmup_steps"] + s["replays"] for s in stats)
                + n_eval)
    require(all(s["captures"] == 1 and s["replays"] == CD_STEPS
                for s in stats)
            and b1["conv_block"] == 27 * forwards
            and b1["flash_fwd"] == 0,
            f"cross-device {tag}: {stats}, launches {b1} (B1 27 x "
            f"(warm-up + replays + {n_eval} eval batches) = "
            f"{27 * forwards} expected)")
    base = _upload_state(os.path.join(cache, "global_round_0.npk"), "cpu")
    ns, ups, decode = [], [], []
    for did in range(1, len(devices) + 1):
        path = os.path.join(cache, f"device_{did}_round_0.npk")
        ns.append(float(np.asarray(fed.train.num_samples)[did - 1]))
        if not wire:
            ups.append(_upload_state(path, "cpu"))
            continue
        blob = load_model(path)
        base_cpu = tree_flatten_to_vector(base).float().numpy()
        want = decode_update(blob, base=base_cpu)
        base_dev = tree_flatten_to_vector(
            {k: v.cuda() for k, v in base.items()}).float()
        got = tree_flatten_to_vector(server.aggregator.decode_upload(
            blob, base_dev)).cpu().numpy()
        decode.append(int(np.sum(got != want)))
        ups.append({k: v.cpu() for k, v in
                    server.aggregator.decode_upload(blob, base_dev).items()})
    require(not any(decode), f"cross-device compressed: decoded uploads "
                             f"differ from the CPU's in {decode} entries")
    # the weighted mean of the uploads, computed apart: f32 on the CPU
    total = sum(ns)
    worst = 0.0
    for k, got in res["params"].items():
        ref = sum(u[k] * (n / total) for u, n in zip(ups, ns))
        bound = HOUSE_TOL[1] + HOUSE_TOL[0] * ref.abs()
        worst = max(worst, float(((got.float().cpu() - ref).abs()
                                  / bound).max()))
    require(worst <= 1.0 and all(torch.isfinite(v).all().item()
                                 for v in res["params"].values()),
            f"cross-device {tag}: the model vs the uploads' weighted mean "
            f"{worst:.3f} of the tolerance")
    rt = res["round_times"][0]
    return {"wall_s": wall, "round_s": rt["wait_s"] + rt["aggregate_s"]
            + rt["eval_s"], "wait_s": rt["wait_s"],
            "aggregate_s": rt["aggregate_s"], "eval_s": rt["eval_s"],
            "b1_launches": b1["conv_block"], "forwards": forwards,
            "warmup_steps": sum(s["warmup_steps"] for s in stats),
            "replays": sum(s["replays"] for s in stats),
            "eval_batches": n_eval,
            "capture_s": [s["capture_s"] for s in stats],
            "within_tolerance": worst, "decode_mismatches": decode,
            "upload_bytes": [os.path.getsize(os.path.join(
                cache, f"device_{i}_round_0.npk"))
                for i in range(1, len(devices) + 1)],
            "test_acc": res["final_test_acc"]}


def cd_native_leg(torch, cb, fa, tmp):
    """Phase 21 (c): the LR / digits session with one native device and
    two torch devices, on the card and on the CPU (TF32 off): the native
    device's round-0 artifact bitwise the CPU's, the global model
    improving over the rounds (its on-device evals)."""
    from fedml_tpu_torch import data, model
    from fedml_tpu_torch.arguments import Arguments
    args = Arguments(**CD_NATIVE)
    fed, od = data.load(args)
    parts = (args, fed, model.create(args, od, fed.input_shape))
    out, art = {}, {}
    for dev in ("cuda", "cpu"):
        cache = os.path.join(tmp, f"cd_native_{dev}")
        res, server, _, b1, wall = cd_session(
            torch, cb, fa, parts, cache, dev=dev,
            engines=["native", None, None])
        with open(os.path.join(cache, "device_1_round_0.npk"), "rb") as f:
            art[dev] = f.read()
        accs = [r.get("device_eval_acc") for r in res["history"]]
        require(all(a is not None for a in accs) and accs[-1] > accs[0]
                and server.devices_online[1]["engine"] == "native",
                f"cross-device native ({dev}): device evals {accs}, "
                f"engines {server.devices_online}")
        out[dev] = {"wall_s": wall, "device_eval_acc": accs,
                    "test_acc": res["final_test_acc"], "launches": b1}
    require(art["cuda"] == art["cpu"], "cross-device native: the native "
                                       "device's artifact differs between "
                                       "the card's session and the CPU's")
    out["native_artifact_bytes"] = len(art["cuda"])
    return out


def cross_device_phase(torch, cb, fa, tmp, card):
    from fedml_tpu_torch import data, model
    from fedml_tpu_torch.arguments import Arguments
    t0 = time.perf_counter()
    args = Arguments(**CD_FULL)
    fed, od = data.load(args)
    parts = (args, fed, model.create(args, od, fed.input_shape))
    dense = cd_flagship(torch, cb, fa, parts, tmp, {})
    comp = cd_flagship(torch, cb, fa, parts, tmp, CD_WIRE)
    nat = cd_native_leg(torch, cb, fa, tmp)
    return {"phase_s": time.perf_counter() - t0, "flagship": dense,
            "compressed": comp, "native": nat, "card": card}


# -- phase 22: multi-rank on the one card ------------------------------------
# The rank programs below run in the rank processes that run_ranks starts
# (``python -m fedml_tpu_torch.core.launch``); they import this module, so
# nothing here may run at import.

def _rank_flags(torch):
    """A rank's numerics for the checks: TF32 off, cuDNN deterministic."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


def _client_axis_leg(torch, w):
    """(a) on this rank: MULTI_RANK with mesh_shape {"client": w}; the
    params, the wall time, the dispatch stats, B1's launches, and the
    round's all-reduce timed alone on a buffer of its size."""
    import fedml_tpu_torch as fedml
    from fedml_tpu_torch.core import collectives
    from fedml_tpu_torch.core.kernels import conv_block as cb
    cb.fused_block.launches = 0
    collectives.reset_collective_stats()
    t0 = time.perf_counter()
    r = fedml.run_simulation(mesh_shape={"client": w}, enable_tracking=False,
                             **MULTI_RANK)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    staged = collectives.collective_stats()["staged_bytes"]
    st = r["dispatch_stats"]
    require(st.get("ranks") == w, f"the run took no client axis: {st}")
    import torch.distributed as dist
    buf = torch.zeros(st["allreduce_bytes"] // 4 // st["allreduce_calls"],
                      device="cuda")
    for _ in range(2):
        collectives.psum_packed([buf], dist.group.WORLD)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(PSUM_TIMED):
        collectives.psum_packed([buf], dist.group.WORLD)
    torch.cuda.synchronize()
    return {"params": {k: v.float().cpu().numpy()
                       for k, v in r["params"].items()},
            "wall_s": wall, "run_wall_time_s": r["wall_time_s"],
            "stats": st, "b1_launches": int(cb.fused_block.launches),
            "staged_bytes": staged,
            "allreduce_ms": (time.perf_counter() - t1) * 1e3 / PSUM_TIMED}


def _ring_inputs(torch, dtype):
    gen = torch.Generator().manual_seed(22)
    b, s, h, d = RING_SHAPE
    q, k, v, cot = (torch.randn(b, s, h, d, generator=gen) for _ in range(4))
    mask = torch.ones(b, s)
    mask[0, :RING_DEAD_KEYS] = 0.0
    # the rows with no live key give zeros in the ring and a uniform mean
    # in dense attention: no cotangent there, so neither's gradients see
    # them, and the outputs are compared on the live rows
    cot[0, :RING_DEAD_KEYS] = 0.0
    return [t.to("cuda", getattr(torch, dtype)) for t in (q, k, v)], \
        cot.to("cuda", getattr(torch, dtype)), mask.to("cuda")


def _rel(torch, got, want):
    got, want = got.detach().float(), want.detach().float()
    return float((got - want).abs().max()
                 / want.abs().max().clamp(min=1e-30))


def _ring_leg(torch):
    """(b) on this rank: ring attention against dense attention on the
    card, and make_ring_forward of the FedLLM model against its dense
    forward."""
    import dataclasses

    import torch.distributed as dist
    from fedml_tpu_torch.arguments import Arguments
    from fedml_tpu_torch.core.mesh import build_mesh
    from fedml_tpu_torch.llm import attention as attn
    from fedml_tpu_torch.llm.federated import llm_config_from_args
    from fedml_tpu_torch.llm.model import CausalLM
    from fedml_tpu_torch.llm.sharding import make_ring_forward
    from torch.func import functional_call
    me, size = dist.get_rank(), dist.get_world_size()
    s_loc = RING_SHAPE[1] // size
    cut = slice(me * s_loc, (me + 1) * s_loc)
    out = {}
    for dtype in ("float32", "bfloat16"):
        (q, k, v), cot, mask = _ring_inputs(torch, dtype)
        for label, m in (("nomask", None), ("mask", mask)):
            full = [t.clone().requires_grad_() for t in (q, k, v)]
            ref = attn.dense_causal_attention(*full, attn_mask=m)
            (ref.float() * cot.float()).sum().backward()
            mine = [t[:, cut].detach().clone().requires_grad_()
                    for t in (q, k, v)]
            t0 = time.perf_counter()
            o = attn.ring_causal_attention(
                *mine, attn_mask=None if m is None else m[:, cut])
            (o.float() * cot[:, cut].float()).sum().backward()
            torch.cuda.synchronize()
            live = (slice(None) if m is None or me else
                    (slice(1, None),))
            errs = [_rel(torch, o[live], ref[:, cut][live])] + [
                _rel(torch, a.grad, b.grad[:, cut])
                for a, b in zip(mine, full)]
            tol = RING_TOL[dtype]
            require(max(errs) <= tol,
                    f"ring {dtype} {label} rank {me}: errors (O, dQ, dK, "
                    f"dV) {errs} over {tol}")
            if m is not None and me == 0:
                require(bool((o[0, :RING_DEAD_KEYS] == 0).all()),
                        f"ring {dtype}: rows with no live key not zero")
            out[f"{dtype}_{label}"] = {
                "rel_err_o_dq_dk_dv": errs,
                "fwd_bwd_s": time.perf_counter() - t0}
    cfg = dataclasses.replace(llm_config_from_args(Arguments(**LLM_MAIN_PATH)),
                              tie_embeddings=False, dtype="float32",
                              attention_impl="dense")
    dense = CausalLM(cfg)
    dense.reset_parameters(torch.Generator().manual_seed(0))
    dense.to("cuda")
    ring = CausalLM(dataclasses.replace(cfg, attention_impl="ring")).to(
        "cuda")
    params = dict(dense.state_dict())
    gen = torch.Generator().manual_seed(23)
    b, s = RING_SHAPE[0], RING_SHAPE[1]
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen).cuda()
    pad = torch.ones(b, s, dtype=torch.int32)
    pad[0, -RING_PAD_TOKENS:] = 0
    pad = pad.cuda()
    fwd = make_ring_forward(lambda p, t, m: functional_call(
        ring, p, (t,), {"attn_mask": m}), build_mesh({"sp": size}))
    with torch.no_grad():
        want = dense(tokens, attn_mask=pad)[:, cut]
        got = fwd(params, tokens, pad)
    real = pad[:, cut].bool()
    err = _rel(torch, got[real], want[real])
    require(err <= RING_TOL["float32"],
            f"make_ring_forward rank {me}: {err} of the largest logit over "
            f"{RING_TOL['float32']}")
    out["model_forward_rel_err"] = err
    return out


def _local_slice(full, dt):
    """The part of the full tensor ``full`` a DTensor ``dt`` holds on
    this rank (its Shard placements applied), without a collective."""
    from torch.distributed.tensor import Shard
    mesh = dt.device_mesh
    for mdim, pl in enumerate(dt.placements):
        if isinstance(pl, Shard):
            full = full.chunk(mesh.size(mdim), dim=pl.dim)[
                mesh.get_local_rank(mdim)]
    return full


def _sharded_leg(torch, meshes, lora=False):
    """(c) on this rank: one SGD step of the FedLLM model (flash, f32)
    sharded at each mesh, against the unsharded step on the card (each
    rank's local shards against their slices of it); with ``lora`` the
    step trains a LoRA adapter on every target with the base (the model's
    factored side path, both factors seeded nonzero); B2-B4 launches per
    mesh."""
    import dataclasses

    from fedml_tpu_torch.arguments import Arguments
    from fedml_tpu_torch.core.algframe.client_trainer import \
        make_inner_optimizer
    from fedml_tpu_torch.core.kernels import flash_attention as fa
    from fedml_tpu_torch.core.mesh import build_mesh
    from fedml_tpu_torch.llm.federated import llm_config_from_args
    from fedml_tpu_torch.llm.lora import lora_shapes
    from fedml_tpu_torch.llm.model import CausalLM
    from fedml_tpu_torch.llm.sharding import (llm_param_specs,
                                              make_sharded_train_step,
                                              shard_llm_params)
    from fedml_tpu_torch.llm.trainer import CausalLMTrainer
    from torch.func import functional_call
    cfg = dataclasses.replace(llm_config_from_args(Arguments(**LLM_MAIN_PATH)),
                              dtype="float32", attention_impl="flash")
    model = CausalLM(cfg)
    model.reset_parameters(torch.Generator().manual_seed(0))
    model.to("cuda")
    params = {k: v.detach() for k, v in model.state_dict().items()}
    adapter = {}
    if lora:
        gen = torch.Generator().manual_seed(25)
        adapter = {k: (torch.randn(shape, generator=gen) * 0.05).cuda()
                   for k, shape in lora_shapes(
                       params, SHARDED_LORA_RANK).items()}
        params = {**params, **adapter}

    def apply(p, x, rng=None, train=False):
        if not adapter:
            return functional_call(model, p, (x,))
        return functional_call(
            model, {k: v for k, v in p.items() if k not in adapter}, (x,),
            {"adapters": {k: p[k] for k in adapter},
             "lora_scale": 16.0 / SHARDED_LORA_RANK})

    spec = CausalLMTrainer(apply)
    gen = torch.Generator().manual_seed(24)
    x = torch.randint(0, cfg.vocab_size, (RING_SHAPE[0], RING_SHAPE[1]),
                      generator=gen).cuda()
    batch = {"x": x, "y": x, "mask": torch.ones(x.shape[0], device="cuda")}
    full = {k: v.clone().requires_grad_() for k, v in params.items()}
    loss0, _ = spec.loss(full, batch)
    loss0.backward()
    want = {k: (v - SHARDED_LR * v.grad).detach() for k, v in full.items()}
    out = {}
    for shape in meshes:
        mesh = build_mesh(shape)
        specs = llm_param_specs(params, mesh)
        sharded = shard_llm_params(params, mesh, specs)
        step = make_sharded_train_step(
            spec.loss, make_inner_optimizer("sgd", SHARDED_LR), mesh, specs)
        for f in (fa.flash_fwd, fa.flash_dq, fa.flash_dkv):
            f.launches = 0
        t0 = time.perf_counter()
        new, _, loss = step(sharded, None, batch, None)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        dl = abs(float(loss) - float(loss0.detach()))
        dp = max(float((new[k].to_local().detach()
                        - _local_slice(want[k], new[k])).abs().max())
                 for k in want)
        da = max((float((new[k].to_local().detach() - want[k]).abs().max())
                  for k in adapter), default=0.0)
        require(dl <= SHARDED_TOL[0] and dp <= SHARDED_TOL[1],
                f"sharded step {shape} (LoRA {lora}): loss off by {dl}, "
                f"params by {dp} (bounds {SHARDED_TOL})")
        launches = {f.__name__: int(f.launches)
                    for f in (fa.flash_fwd, fa.flash_dq, fa.flash_dkv)}
        require(all(launches.values()),
                f"sharded step {shape}: a flash kernel never ran "
                f"{launches}")
        out[json.dumps(shape)] = {
            "loss": float(loss), "loss_err": dl, "param_err": dp,
            "adapter_err": da, "adapters": len(adapter),
            "step_s": step_s, "launches": launches,
            "local_shapes": {k: list(v.to_local().shape)
                             for k, v in list(new.items())[:4]}}
    return out


def _robust_leg(torch, cfg, mesh_shape=None, pours=None):
    """(d) / (e) on this rank (or, with no ``mesh_shape``, the plain
    engine in this process): the run's params, wall time, dispatch stats,
    collectives, B1's launches, verdicts and the defense's input (this
    rank's feature shard, f32). Buffered-async (``pours``): the bootstrap,
    then ``pours`` timed pours, and every cohort drawn."""
    import fedml_tpu_torch.core.security.defense.sharded as sharded
    from fedml_tpu_torch.core import collectives
    from fedml_tpu_torch.core.algframe.types import TrainHyper
    from fedml_tpu_torch.core.kernels import conv_block as cb
    if mesh_shape is not None:
        cfg = dict(cfg, mesh_shape=mesh_shape)
    sim = _tail_runner(cfg, "cuda").runner
    seen, real = [], sharded.defend_shard_stateful

    def record(mat, *a, **kw):
        seen.append(mat.detach().float().cpu().numpy())
        return real(mat, *a, **kw)

    cohorts, draw = [], getattr(sim, "_draw_cohort", None)
    if pours is not None:
        def drawn(target):
            cohorts.append(list(draw(target)))
            return cohorts[-1]
        sim._draw_cohort = drawn
    cb.fused_block.launches = 0
    collectives.reset_collective_stats()
    sharded.defend_shard_stateful = record
    try:
        t0 = time.perf_counter()
        if pours is None:
            sim.run()
            timed = None
        else:
            hyper = TrainHyper(learning_rate=float(cfg["learning_rate"]),
                               epochs=int(cfg["epochs"]))
            sim._bootstrap(hyper)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            for _ in range(pours):
                sim._pour_step(hyper)
            torch.cuda.synchronize()
            timed = (time.perf_counter() - t1) / pours
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        sharded.defend_shard_stateful = real
    sim._update_program_stats()
    return {"params": {k: v.float().cpu().numpy()
                       for k, v in sim.params.items()},
            "wall_s": wall, "pour_s": timed, "cohorts": cohorts,
            "stats": dict(sim.dispatch_stats),
            "collectives": collectives.collective_stats(),
            "b1_launches": int(cb.fused_block.launches),
            "verdicts": {int(v): [list(map(int, ids)),
                                  [float(x) for x in verdict]]
                         for v, (ids, verdict) in sim.verdicts.items()},
            "defense_input": seen}


def _robust_rank_legs(torch, w):
    """(d) and (e) on this rank."""
    out = {q: _robust_leg(torch, dict(MULTI_RANK_DEFENDED,
                                      robust_relayout_quant=q),
                          {"client": w})
           for q in MULTI_RANK_RELAYOUTS}
    out["async"] = _robust_leg(torch, MULTI_RANK_ASYNC, {"client": w},
                               pours=1)
    return out


def multi_rank_gloo():
    """The two gloo ranks' program: (a) at {"client": 2}, (b), (c) at
    SHARDED_MESH_TP2 with LoRA, (d), (e)."""
    import torch
    import torch.distributed as dist
    from fedml_tpu_torch.core import collectives
    from fedml_tpu_torch.core.mesh import init_ranks
    _rank_flags(torch)
    dev = init_ranks()
    out = {"backend": dist.get_backend(), "device": str(dev)}
    out["client_axis"] = _client_axis_leg(torch, dist.get_world_size())
    collectives.reset_collective_stats()
    out["ring"] = _ring_leg(torch)
    out["ring"]["collectives"] = collectives.collective_stats()
    out["sharded_lora"] = _sharded_leg(torch, (SHARDED_MESH_TP2,),
                                       lora=True)
    out["robust"] = _robust_rank_legs(torch, dist.get_world_size())
    return out


def multi_rank_nccl():
    """The NCCL group of one rank: (a) at {"client": 1}, (c)."""
    import torch
    import torch.distributed as dist
    from fedml_tpu_torch.core.mesh import init_ranks
    _rank_flags(torch)
    dev = init_ranks()
    return {"backend": dist.get_backend(), "device": str(dev),
            "client_axis": _client_axis_leg(torch, 1),
            "sharded": _sharded_leg(torch, (SHARDED_MESH_ONE,)),
            "sharded_lora": _sharded_leg(torch, (SHARDED_MESH_ONE,),
                                         lora=True)}


def _robust_phase_checks(np, ref, ranks):
    """(d) and (e): the two ranks' runs against the one-rank runs ``ref``
    (the checks the phase requires), and what each leg reports."""
    rtol, atol = HOUSE_TOL
    out = {}
    for leg, one in ref.items():
        runs = [r[leg] for r in ranks]
        p0, p1 = runs[0]["params"], one["params"]
        require(all(np.array_equal(p0[k], r["params"][k])
                    for r in runs[1:] for k in p0),
                f"(d/e) {leg}: the two ranks' params differ")
        within = max(float(np.max(np.abs(p0[k] - p1[k])
                                  / (atol + rtol * np.abs(p1[k]))))
                     for k in p1)
        rec = {"vs_one_rank_of_tolerance": within,
               "one_rank_wall_s": one["wall_s"],
               "ranks_wall_s": [r["wall_s"] for r in runs],
               "ranks_bitwise_equal": True}
        if leg == "async":
            require(within <= 1.0, f"(e) async: {within} of the house "
                                   f"tolerance from one rank")
            require(all(r["cohorts"] == one["cohorts"] for r in runs),
                    f"(e) async: cohorts {runs[0]['cohorts']} != one "
                    f"rank's {one['cohorts']}")
            rec.update(cohorts=one["cohorts"],
                       pour_s=[r["pour_s"] for r in runs],
                       one_rank_pour_s=one["pour_s"])
        else:
            require(all(r["verdicts"] == one["verdicts"] for r in runs),
                    f"(d) {leg}: verdicts {runs[0]['verdicts']} != one "
                    f"rank's {one['verdicts']}")
            # the defense's input: the ranks' feature shards side by side
            # against the one rank's matrix, round by round
            d = one["defense_input"][0].shape[1]
            flips = 0
            for i, m1 in enumerate(one["defense_input"]):
                m2 = np.concatenate([r["defense_input"][i] for r in runs],
                                    axis=1)[:, :d]
                flips = max(flips, float(np.mean(m2 != m1)))
            if leg == "int8":
                require(flips <= RELAYOUT_FLIP_SHARE,
                        f"(d) int8: {flips} of the defense input's entries "
                        f"on another level (bound {RELAYOUT_FLIP_SHARE})")
            else:
                require(within <= 1.0, f"(d) {leg}: {within} of the house "
                                       f"tolerance from one rank")
            st = [r["stats"] for r in runs]
            for r, s_ in zip(runs, st):
                g = MULTI_RANKS
                require(s_["all_to_all_wire_bytes"] * g ==
                        s_["all_to_all_bytes"] * (g - 1)
                        and s_["all_to_all_calls"] >= 1,
                        f"(d) {leg}: all-to-all counted {s_}")
            rec.update(
                defense_input_other_share=flips,
                all_to_all_calls=[s_["all_to_all_calls"] for s_ in st],
                all_to_all_bytes=[s_["all_to_all_bytes"] for s_ in st],
                all_to_all_wire_bytes=[s_["all_to_all_wire_bytes"]
                                       for s_ in st],
                all_to_all_ms=[s_["all_to_all_s"] * 1e3 for s_ in st],
                all_gather_wire_bytes=[s_["all_gather_wire_bytes"]
                                       for s_ in st],
                staged_bytes=[r["collectives"]["staged_bytes"]
                              for r in runs],
                verdicts=one["verdicts"])
        for name, r in [("one_rank", one)] + [(f"rank{i}", r)
                                              for i, r in enumerate(runs)]:
            st = r["stats"]
            forwards = st["warmup_steps"] + st["replays"]
            require(r["b1_launches"] == 27 * forwards,
                    f"(d/e) {leg} {name}: B1 {r['b1_launches']} != 27 x "
                    f"{forwards}")
            rec[f"b1_launches_{name}"] = r["b1_launches"]
        out[leg] = rec
    return out


def multi_rank_phase(torch, cb, fa, card):
    """Phase 22: the plain engine here, then the NCCL group of one rank and
    the two gloo ranks (kernels already built by this process)."""
    import numpy as np

    import fedml_tpu_torch as fedml
    from fedml_tpu_torch.core.launch import run_ranks
    t0 = time.perf_counter()
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        reset_launches(cb, fa)
        t1 = time.perf_counter()
        plain = fedml.run_simulation(enable_tracking=False, **MULTI_RANK)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t1
        plain_b1 = launches(cb, fa)["conv_block"]
        # (d), (e) on one rank: what the two ranks are held against
        ref = {q: _robust_leg(torch, dict(MULTI_RANK_DEFENDED,
                                          robust_relayout_quant=q))
               for q in MULTI_RANK_RELAYOUTS}
        ref["async"] = _robust_leg(torch, MULTI_RANK_ASYNC, pours=1)
    finally:
        torch.backends.cudnn.deterministic = det
    p0 = {k: v.float().cpu().numpy() for k, v in plain["params"].items()}
    (one,) = run_ranks("chip_smoke:multi_rank_nccl", 1,
                       timeout=MULTI_RANK_JOIN_S, threads=4)
    two = run_ranks("chip_smoke:multi_rank_gloo", MULTI_RANKS,
                    timeout=MULTI_RANK_JOIN_S, threads=4)
    require(one["backend"] == "nccl", f"one rank: backend {one['backend']}")
    require(all(r["backend"] == "gloo" for r in two),
            f"two ranks on one card: backends {[r['backend'] for r in two]}")
    p1 = one["client_axis"]["params"]
    require(all(np.array_equal(p0[k], p1[k]) for k in p0),
            "the NCCL rank's {'client': 1} run differs from the plain "
            "engine")
    p2 = [r["client_axis"]["params"] for r in two]
    require(all(np.array_equal(p2[0][k], p2[1][k]) for k in p0),
            "the two ranks' params differ")
    rtol, atol = HOUSE_TOL
    within = max(float(np.max(np.abs(p2[0][k] - p1[k])
                              / (atol + rtol * np.abs(p1[k])))) for k in p1)
    require(within <= 1.0, f"{{'client': 2}} vs {{'client': 1}}: {within} "
                           f"of the house tolerance")
    legs = {"plain": {"wall_s": plain_s, "b1_launches": plain_b1,
                      "stats": plain["dispatch_stats"]},
            "nccl_1": {k: v for k, v in one["client_axis"].items()
                       if k != "params"}}
    for r, rk in enumerate(two):
        legs[f"gloo_2_rank{r}"] = {k: v for k, v in rk["client_axis"].items()
                                   if k != "params"}
    for name, leg in legs.items():
        st = leg["stats"]
        forwards = st["warmup_steps"] + st["replays"]
        require(leg["b1_launches"] == 27 * forwards,
                f"{name}: B1 {leg['b1_launches']} != 27 x {forwards}")
        leg["b1_forwards"] = forwards
    sharded = [one["sharded"]]
    robust = _robust_phase_checks(np, ref, [r["robust"] for r in two])
    return {"phase_s": time.perf_counter() - t0, "card": card,
            "robust": robust,
            "sharded_lora": {"nccl_1": one["sharded_lora"],
                             "gloo_2": [r["sharded_lora"] for r in two]},
            "client_axis": {"legs": legs, "vs_one_rank_of_tolerance": within,
                            "one_rank_bitwise_plain": True,
                            "ranks_bitwise_equal": True},
            "ring": [r["ring"] for r in two],
            "sharded": sharded,
            "b1_launches_ranks": [r["client_axis"]["b1_launches"]
                                  for r in two],
            "b1_launches_nccl_1": one["client_axis"]["b1_launches"],
            "b1_launches_plain": plain_b1}



# -- phase 23: the long tail of training ------------------------------------

# (a) every model this slice ported, card against CPU in f32 with TF32 off
# (the logits and the gradients of sum(logits * cotangent), from the same
# seeded params and input): name -> (model hub name, one sample's shape,
# classes, batch). The GAN pair, SegNet and the GKT / NAS nets are built
# apart (TAIL_EXTRA).
TAIL_MODELS = {
    "lenet": ("lenet", (28, 28, 1), 10, 8),
    "vfl_feature_extractor": ("vfl_feature_extractor", (12,), 32, 8),
    "vfl_classifier": ("vfl_classifier", (64,), 2, 8),
    "lending_club_mlp": ("lending_club_mlp", (12,), 2, 8),
    "vgg11": ("vgg11", (32, 32, 3), 10, 4),
    "vgg16": ("vgg16", (32, 32, 3), 10, 4),
    "mobilenet": ("mobilenet", (28, 28, 1), 62, 8),
    "efficientnet-b0": ("efficientnet-b0", (32, 32, 3), 10, 4),
}
TAIL_EXTRA = ("generator", "discriminator", "segnet", "gkt_edge",
              "gkt_head", "nas_supernet")
# the 1-channel stems whose cuDNN filter gradient was off on the card
# (scripts/tail_probe.py wgrad: SimpleCNN's 5x5 at batch 8, 0.340 of a
# largest entry 291.7), now GEMMs, held card vs CPU at the batch measured
TAIL_STEMS = {"simple_cnn": ("simple_cnn", (28, 28, 1), 10, 8)}
# a gradient entry of a deep conv net sums over every pixel and sample:
# its rounding follows the largest entry of that gradient, so the
# absolute part of the house tolerance is scaled by it (when above 1),
# as tests/test_torch_models_tail.py does on the CPU
# bf16 MobileNetV3-Small against its f32 self, over the largest f32 logit
# (the CPU gives ~0.045 at a seeded init; bf16 keeps 8 bits)
TAIL_BF16_BOUND = 2.0 ** -3
# (b) the four MLP / conv protocol simulators at tests/test_protocols.py's
# configurations (the JAX defaults' widths), 2 rounds each, card vs CPU.
# Training amplifies rounding (ReLU and argmax boundaries, Adam's
# normalisation), so the house tolerance is held after the first round
# (TAIL_GATED_ROUNDS), where the CPU's own drift from its initial params
# moved one ulp stays inside it (scripts/tail_probe.py drift); the
# second round's drift is reported beside it. FedGAN's data is cut in
# depth to 512 samples (5 batches a client): over the full 4,000 the
# CPU's own one-ulp drift is 3.6x the tolerance after one round.
TAIL_PROTO_BASE = dict(dataset="synthetic_mnist", model="lr",
                       client_num_in_total=4, client_num_per_round=4,
                       comm_round=2, epochs=1, batch_size=32,
                       learning_rate=0.1, frequency_of_the_test=3,
                       random_seed=17, enable_tracking=False)
TAIL_GATED_ROUNDS = 1
# an accuracy moves by 1e-3 per test sample that flips (1,000 samples;
# FedGAN's 256 + 256 by 2e-3; a few pixels move FedSeg's mIoU less)
TAIL_ACC_DIFF = 0.01
TAIL_PROTOCOLS = {
    "FedGKT": dict(TAIL_PROTO_BASE, federated_optimizer="FedGKT"),
    "FedNAS": dict(TAIL_PROTO_BASE, federated_optimizer="FedNAS",
                   learning_rate=0.05),
    "FedSeg": dict(TAIL_PROTO_BASE, federated_optimizer="FedSeg",
                   dataset="synthetic_seg", learning_rate=0.2,
                   batch_size=16),
    "FedGAN": dict(TAIL_PROTO_BASE, federated_optimizer="FedGAN",
                   model="gan", learning_rate=2e-4, max_total_samples=512),
}
# (c) bench.py's bench_hierarchical_femnist (BASELINE config 5): FEMNIST
# shapes through the synthetic stand-in, MobileNetV3-Small in bf16, 24
# clients, 4 groups x 2 edge rounds, batch 16; 1 warm-up and
# TAIL_FEMNIST_TIMED timed global rounds
TAIL_FEMNIST = dict(dataset="femnist", model="mobilenet",
                    precision="bfloat16", client_num_in_total=24,
                    client_num_per_round=24, comm_round=1, epochs=1,
                    batch_size=16, learning_rate=0.05, group_num=4,
                    group_comm_round=2, federated_optimizer="hierarchicalfl",
                    frequency_of_the_test=-1, random_seed=0,
                    allow_synthetic=True, enable_tracking=False)
TAIL_FEMNIST_TIMED = 1
# (d) the flagship's widths with B1 (ResNet-56, synthetic CIFAR-10, batch
# 32, bf16, the fused block), its data cut in depth to CS_FULL's 25,000
# samples: turbo_aggregate over 8 of 64 clients in 2 groups, 1 round; the
# centralized trainer over 4,096 pooled samples (128 steps), 1 epoch and
# its eval
TAIL_TURBO = dict(dataset="synthetic_cifar10", model="resnet56",
                  precision="bfloat16", fused_conv_block="pallas",
                  federated_optimizer="turbo_aggregate", turbo_groups=2,
                  client_num_in_total=64, client_num_per_round=8,
                  comm_round=1, epochs=1, batch_size=32, learning_rate=0.1,
                  synthetic_size=25000, synthetic_test_size=1000,
                  frequency_of_the_test=1, random_seed=0,
                  enable_tracking=False)
TAIL_CENTRAL = dict(TAIL_TURBO, federated_optimizer="centralized",
                    max_total_samples=4096)
TAIL_QUANTUM = 2.0 ** -16


def _scaled_ratio(torch, got, want):
    """max |got - want| / (atol * max(1, max|want|) + rtol |want|) under
    HOUSE_TOL: at most 1 passes."""
    rtol, atol = HOUSE_TOL
    want = want.detach().float().cpu()
    got = got.detach().float().cpu()
    scale = max(1.0, want.abs().max().item())
    return ((got - want).abs() / (atol * scale + rtol * want.abs())
            ).max().item()


def _tail_model(torch, name):
    """``(module, input shape, key or None)`` of a phase-23 (a) model."""
    import numpy as np
    from fedml_tpu_torch import prng
    from fedml_tpu_torch.arguments import Arguments
    from fedml_tpu_torch.model import model_hub
    from fedml_tpu_torch.model.cv.gan import Discriminator, Generator
    from fedml_tpu_torch.simulation.sp.fedgkt import _EdgeNet, _ServerHead
    from fedml_tpu_torch.simulation.sp.fednas import _SuperNet
    from fedml_tpu_torch.simulation.sp.fedseg import SegNet
    if name in TAIL_MODELS or name in TAIL_STEMS:
        hub, shape, classes, bs = {**TAIL_MODELS, **TAIL_STEMS}[name]
        b = model_hub.create(Arguments(model=hub), classes, shape)
        key = (np.asarray(prng.PRNGKey(5)) if b.has_dropout else None)
        return b.module, (bs,) + shape, key
    return {"generator": (Generator(), (8, 100), None),
            "discriminator": (Discriminator(), (8, 28, 28, 1), None),
            "segnet": (SegNet(3), (4, 16, 16, 3), None),
            "gkt_edge": (_EdgeNet(784, 64, 10), (8, 28, 28, 1), None),
            "gkt_head": (_ServerHead(64, 10), (8, 64), None),
            "nas_supernet": (_SuperNet(784, 10), (8, 784), None)}[name]


def tail_models(torch, dev="cuda", cpu="cpu"):
    """Phase 23 (a): each model's logits and gradients on the card against
    the CPU, f32 (TF32 off, cuDNN deterministic); dropout models in
    training mode from one key; bf16 MobileNetV3-Small against its f32
    self. Returns {name: record}."""
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        return _tail_models(torch, dev, cpu)
    finally:
        torch.backends.cudnn.deterministic = det


def _tail_models(torch, dev, cpu):
    from fedml_tpu_torch import prng
    from fedml_tpu_torch.model.model_hub import ModelBundle
    out = {}
    for i, name in enumerate(list(TAIL_MODELS) + list(TAIL_EXTRA)
                             + list(TAIL_STEMS)):
        module, shape, key = _tail_model(torch, name)
        module.reset_parameters(torch.Generator().manual_seed(i))
        gen = torch.Generator().manual_seed(100 + i)
        x = torch.randn(shape, generator=gen)
        extra = ((torch.randn(2, 4, generator=gen),)
                 if name == "nas_supernet" else ())
        params = {k: v.detach().clone()
                  for k, v in module.state_dict().items()}
        runs = {}
        for d in (cpu, dev):
            module.to(d)
            module.train(key is not None)
            leaves = {k: v.to(d).requires_grad_() for k, v in params.items()}
            kw = {} if key is None else {"rng": prng.key_t(key, d)}
            o = torch.func.functional_call(
                module, leaves, (x.to(d),) + tuple(e.to(d) for e in extra),
                kw)
            o = o[1] if isinstance(o, tuple) else o
            cot = torch.randn(o.shape, generator=torch.Generator()
                              .manual_seed(7)).to(d)
            g = torch.autograd.grad((o * cot).sum(), list(leaves.values()))
            runs[d] = (o.detach(), dict(zip(leaves, g)))
        (oc, gc), (od, gd) = runs[cpu], runs[dev]
        rec = {"logits": _house_ratio(torch, {"o": od}, {"o": oc}),
               "grads": max(_scaled_ratio(torch, gd[k], gc[k])
                            for k in gc),
               "params": sum(v.numel() for v in params.values()),
               "train_mode": key is not None}
        require(rec["logits"] <= 1.0 and rec["grads"] <= 1.0,
                f"phase 23 (a) {name}: card vs CPU {rec}")
        out[name] = rec
        if name == "mobilenet":
            b16 = ModelBundle(module, "mobilenet",
                              compute_dtype=torch.bfloat16)
            p = {k: v.to(dev) for k, v in params.items()}
            with torch.no_grad():
                o16 = b16.apply(p, x.to(dev))
                o32 = ModelBundle(module, "mobilenet").apply(p, x.to(dev))
            rel = ((o16 - o32).abs().max() / o32.abs().max()).item()
            require(rel <= TAIL_BF16_BOUND,
                    f"phase 23 (a) bf16 MobileNet: {rel} of the largest f32 "
                    f"logit (bound {TAIL_BF16_BOUND})")
            out["mobilenet_bf16_vs_f32"] = rel
        module.to(cpu)
    return out


def _tail_runner(cfg, dev, init_params=None):
    """The runner of the simulator ``cfg`` names, built on ``dev``."""
    from fedml_tpu_torch import data, model
    from fedml_tpu_torch.arguments import Arguments
    from fedml_tpu_torch.runner import FedMLRunner
    args = Arguments(**cfg)
    fed, n_classes = data.load(args)
    bundle = model.create(args, n_classes, fed.input_shape)
    return FedMLRunner(args, device=dev, dataset=fed, model=bundle,
                       init_params=init_params)


def _tail_run(torch, cfg, dev, init_params=None):
    """The protocol simulator ``cfg`` names, built on ``dev`` through the
    runner (from ``init_params`` when given), and its result."""
    runner = _tail_runner(cfg, dev, init_params)
    t0 = time.perf_counter()
    result = runner.run()
    if str(dev).startswith("cuda"):
        torch.cuda.synchronize()
    return runner.runner, result, time.perf_counter() - t0


def _tail_pairs(name, a, b):
    """The (card, CPU) parameter dicts of two protocol results."""
    if name == "FedGKT":
        return [(a["params"], b["params"])] + list(
            zip(a["edge_params"], b["edge_params"]))
    if name == "FedGAN":
        return [(a["gen_params"], b["gen_params"]),
                (a["disc_params"], b["disc_params"])]
    if name == "FedNAS":
        return [(a["params"], b["params"]),
                ({"a": a["alphas"]}, {"a": b["alphas"]})]
    return [(a["params"], b["params"])]


def _tail_state(sim, name):
    """A protocol simulator's parameters now, copied to the CPU, keyed as
    its result is (and FedNAS's derived architecture)."""
    cp = lambda p: {k: v.detach().cpu().clone()  # noqa: E731
                    for k, v in p.items()}
    if name == "FedGKT":
        return {"params": cp(sim.head_params),
                "edge_params": [cp(e) for e in sim.edge_params]}
    if name == "FedGAN":
        return {"gen_params": cp(sim.gen_params),
                "disc_params": cp(sim.disc_params)}
    if name == "FedNAS":
        return {"params": cp(sim.params), "alphas": sim.alphas.cpu().clone(),
                "architecture": sim.derive_architecture()}
    return {"params": cp(sim.params)}


def _tail_rounds(torch, cfg, dev, name, init_params=None):
    """The protocol simulator ``cfg`` names, run on ``dev`` (from
    ``init_params`` when given); returns its result, its parameters at the
    end of every round (taken where it appends the round's history
    record) and the seconds."""
    runner = _tail_runner(cfg, dev, init_params)
    sim, states = runner.runner, []

    class Rounds(list):
        def append(self, rec):
            states.append(_tail_state(sim, name))
            super().append(rec)

    sim.history = Rounds()
    t0 = time.perf_counter()
    result = runner.run()
    if str(dev).startswith("cuda"):
        torch.cuda.synchronize()
    return result, states, time.perf_counter() - t0


def _tail_history(a, b):
    """The worst history loss over the house tolerance, and the largest
    accuracy difference, of two runs' history records."""
    rtol, atol = HOUSE_TOL
    worst_hist, worst_acc = 0.0, 0.0
    for hc, hr in zip(a, b):
        for k, v in hr.items():
            if k in ("round", "architecture"):
                continue
            if k in ("test_acc", "miou", "disc_acc"):
                worst_acc = max(worst_acc, abs(hc[k] - v))
            else:
                worst_hist = max(worst_hist, abs(hc[k] - v)
                                 / (atol + rtol * abs(v)))
    return worst_hist, worst_acc


def _tail_drift(torch, name, cfg, a, b, sa, sb, rounds):
    """Two runs of one protocol compared after their first ``rounds``
    rounds: the params and the history losses over the house tolerance
    (FedGAN's params plus two Adam steps of lr: an entry whose gradient
    is at rounding level steps either way), the largest accuracy
    difference."""
    extra = 2 * cfg["learning_rate"] if name == "FedGAN" else 0.0
    hist, acc = _tail_history(a["history"][:rounds], b["history"][:rounds])
    return {"params_of_tolerance": max(
                _house_ratio(torch, x, y, extra)
                for x, y in _tail_pairs(name, sa[rounds - 1],
                                        sb[rounds - 1])),
            "history_of_tolerance": hist, "acc_diff": acc}


def tail_protocols(torch, dev="cuda", cpu="cpu", cfgs=None):
    """Phase 23 (b): FedGKT, FedNAS, FedSeg and FedGAN, 2 rounds each on
    the card and on the CPU (cuDNN deterministic), compared after
    TAIL_GATED_ROUNDS rounds: the params and the history's losses within
    the house tolerance, accuracies (FedSeg's mIoU, FedGAN's
    real-vs-fake accuracy) within TAIL_ACC_DIFF, FedNAS's architecture
    equal there and at the end. The drift after both rounds is reported,
    not held. Returns {protocol: record}."""
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    out = {}
    try:
        for name, cfg in (cfgs or TAIL_PROTOCOLS).items():
            rc, sc, card_s = _tail_rounds(torch, cfg, dev, name)
            rr, sr, cpu_s = _tail_rounds(torch, cfg, cpu, name)
            k = TAIL_GATED_ROUNDS
            rec = dict(_tail_drift(torch, name, cfg, rc, rr, sc, sr, k),
                       gated_rounds=k, rounds=len(sc),
                       all_rounds=_tail_drift(torch, name, cfg, rc, rr,
                                              sc, sr, len(sc)),
                       card_s=card_s, cpu_s=cpu_s,
                       final={key: v for key, v in rc["history"][-1].items()
                              if key != "round"})
            if name == "FedNAS":
                require(sc[k - 1]["architecture"] == sr[k - 1]["architecture"]
                        and rc["architecture"] == rr["architecture"],
                        f"phase 23 (b) FedNAS architecture "
                        f"{rc['architecture']} != {rr['architecture']}")
                rec["architecture"] = rc["architecture"]
            require(len(sc) == len(sr) == cfg["comm_round"]
                    and all(hc["round"] == hr["round"] for hc, hr in
                            zip(rc["history"], rr["history"]))
                    and rec["params_of_tolerance"] <= 1.0
                    and rec["history_of_tolerance"] <= 1.0
                    and rec["acc_diff"] <= TAIL_ACC_DIFF,
                    f"phase 23 (b) {name}: card vs CPU {rec}")
            out[name] = rec
    finally:
        torch.backends.cudnn.deterministic = det
    return out


def tail_femnist(torch, dev="cuda", cfg=None):
    """Phase 23 (c): bench_hierarchical_femnist's configuration through
    the runner (the hierarchicalfl simulator, MobileNetV3-Small bf16):
    1 warm-up global round, then TAIL_FEMNIST_TIMED timed; then one eval
    of the model (finite, accuracy reported)."""
    import math

    from fedml_tpu_torch.core.algframe.local_training import evaluate
    sim, _, warm_s = _tail_run(torch, cfg or TAIL_FEMNIST, dev)
    t0 = time.perf_counter()
    for _ in range(TAIL_FEMNIST_TIMED):
        sim.run(comm_round=1)
    if str(dev).startswith("cuda"):
        torch.cuda.synchronize()
    round_s = (time.perf_counter() - t0) / TAIL_FEMNIST_TIMED
    stats = evaluate(sim.spec, sim.params, sim.test["x"], sim.test["y"],
                     sim.test["mask"])
    acc = float(stats["correct"]) / max(float(stats["count"]), 1.0)
    require(all(bool(torch.isfinite(v).all()) for v in sim.params.values())
            and math.isfinite(acc), "phase 23 (c): non-finite model")
    return {"s_per_global_round": round_s,
            "hierarchical_femnist_mobilenet_rounds_per_hour":
                3600.0 / round_s,
            "warmup_round_s": warm_s, "test_acc": acc,
            "provenance": getattr(sim.fed, "provenance", None),
            "clients": int(sim.fed.num_clients),
            "train_samples": int(sim.fed.client_num_samples.sum())}


def _forwards(progs, eval_batches):
    st = {k: sum(getattr(p, k) for p in progs)
          for k in ("warmup_steps", "replays", "captures", "capture_s")}
    return st["warmup_steps"] + st["replays"] + eval_batches, st


def tail_full_width(torch, cb, fa, dev="cuda", turbo=None, central=None):
    """Phase 23 (d): turbo_aggregate and the centralized trainer at the
    flagship's widths with B1. The turbo model against plain FedAvg of the
    same clients' updates (float64) to one 2^-16 quantum per client; B1
    launches = 27 x (warm-up + replayed steps + eval batches) for each
    (read from the wrappers' counters)."""
    import numpy as np

    from fedml_tpu_torch.core.collectives import tree_flatten_to_vector
    on_card = str(dev).startswith("cuda")
    out = {}
    # turbo_aggregate: the ring's inputs recorded on the way in
    reset_launches(cb, fa)
    from fedml_tpu_torch import data, model
    from fedml_tpu_torch.arguments import Arguments
    from fedml_tpu_torch.runner import FedMLRunner
    cfg = turbo or TAIL_TURBO
    args = Arguments(**cfg)
    fed, n_classes = data.load(args)
    sim = FedMLRunner(args, device=dev, dataset=fed, model=model.create(
        args, n_classes, fed.input_shape)).runner
    p0 = tree_flatten_to_vector(sim.params).cpu().numpy()
    seen = {}
    ring = sim._ring_aggregate

    def recording(updates, weights, r):
        seen.update(updates=[u.copy() for u in updates], weights=weights)
        seen["agg"] = ring(updates, weights, r)
        return seen["agg"]

    sim._ring_aggregate = recording
    t0 = time.perf_counter()
    res = sim.run()
    if on_card:
        torch.cuda.synchronize()
    turbo_s = time.perf_counter() - t0
    w = np.asarray(seen["weights"], np.float64)
    plain = sum(u * wi for u, wi in zip(seen["updates"], w)) / w.sum()
    n = len(w)
    agg_err = float(np.max(np.abs(seen["agg"] - plain)))
    model_err = float(np.max(np.abs(
        tree_flatten_to_vector(res["params"]).cpu().numpy().astype(
            np.float64) - (p0.astype(np.float64) + plain))))
    eval_batches = int(sim.test["x"].shape[0])
    fwd, st = _forwards(sim.programs.values(), eval_batches)
    b1 = launches(cb, fa)["conv_block"]
    # the model's f32 rounding of p0 + agg adds at most one ulp of the
    # largest param on top of the quanta
    ulp = float(np.spacing(np.float32(np.max(np.abs(p0)) + 1.0)))
    require(agg_err <= n * TAIL_QUANTUM and model_err <= n * TAIL_QUANTUM
            + ulp, f"phase 23 (d) turbo: aggregate {agg_err}, model "
                   f"{model_err} vs plain FedAvg (bound {n} quanta)")
    if on_card:
        require(b1 == 27 * fwd, f"phase 23 (d) turbo: B1 {b1} != 27 x "
                                f"{fwd}")
    out["turbo"] = {"s_per_round": turbo_s, "clients": n,
                    "groups": sim.groups, "agg_vs_fedavg": agg_err,
                    "model_vs_fedavg": model_err,
                    "quanta_bound": n * TAIL_QUANTUM,
                    "b1_launches": b1, "forwards": fwd, **st,
                    "eval_batches": eval_batches,
                    "test_acc": res["final_test_acc"]}
    del sim
    # centralized: 128 captured steps over the pooled samples, one eval
    reset_launches(cb, fa)
    sim, res, central_s = _tail_run(torch, central or TAIL_CENTRAL, dev)
    eval_batches = int(sim.test["x"].shape[0])
    fwd, st = _forwards([sim.program], eval_batches)
    b1 = launches(cb, fa)["conv_block"]
    steps = int(sim.data.x.shape[0])
    require(np.isfinite(res["history"][-1]["train_loss"])
            and res["final_test_acc"] is not None,
            f"phase 23 (d) centralized: {res['history']}")
    if on_card:
        require(st["replays"] == steps and b1 == 27 * fwd,
                f"phase 23 (d) centralized: B1 {b1} != 27 x {fwd} "
                f"({st['replays']} replays of {steps} steps)")
    out["centralized"] = {
        "s_per_epoch": central_s, "steps": steps,
        "s_per_step": (central_s - st["capture_s"]) / max(steps, 1),
        "b1_launches": b1, "forwards": fwd, **st,
        "eval_batches": eval_batches,
        "train_loss": res["history"][-1]["train_loss"],
        "test_acc": res["final_test_acc"]}
    if on_card:
        torch.cuda.empty_cache()
    return out


def tail_phase(torch, cb, fa, card, dev="cuda", cpu="cpu"):
    """Phase 23: (a) the new models card vs CPU, (b) the four protocol
    simulators card vs CPU, (c) bench_hierarchical_femnist's round, (d)
    turbo_aggregate and centralized at the flagship's widths with B1."""
    t0 = time.perf_counter()
    rec = {"card": card}
    for part, fn in (("models", lambda: tail_models(torch, dev, cpu)),
                     ("protocols", lambda: tail_protocols(torch, dev, cpu)),
                     ("femnist", lambda: tail_femnist(torch, dev)),
                     ("full_width", lambda: tail_full_width(torch, cb, fa,
                                                            dev))):
        t1 = time.perf_counter()
        rec[part] = fn()
        rec[f"{part}_s"] = time.perf_counter() - t1
    rec["phase_s"] = time.perf_counter() - t0
    return rec


# -- phase 24: the platform --------------------------------------------------

# MAIN_PATH's ResNet-56 (bf16, the fused B1, synthetic CIFAR-10, batch 32)
# cut in depth only: 8 of 8 clients over 2,048 training samples (8 steps a
# client; drawn from the loader's smallest synthetic pool, 4,000), 256 test
# samples (one eval batch: the loader's eval batch is 256), 1 round in a
# block of 1, eval after it. Written as a yaml: (b) trained in this
# process through the CLI's train command, (c) dispatched through a
# broker, a master and an agent as a training job (a CLI subprocess on the
# card), (d) its artifact served by api.model_serve.
PLATFORM_PATH = dict(MAIN_PATH, client_num_in_total=8, client_num_per_round=8,
                     synthetic_size=4000, max_total_samples=2048,
                     synthetic_test_size=256, comm_round=1,
                     rounds_per_dispatch=1, frequency_of_the_test=1,
                     enable_tracking=False)
PLATFORM_DEVICE_ID = 24
PLATFORM_JOB_S = 600.0
# (c) is held bitwise to (b): the same yaml from the same seed in two
# processes on the card, both under torch's default numerics. In
# scripts/platform_spread.py's readings every run of the same job agreed
# bitwise (CLI subprocesses, and runs with cuDNN's deterministic mode, its
# benchmark mode or TF32 off), while a job with another precision or conv
# path landed 0.17-0.18 of the round's update away; a bound between the
# two would rest on no reading of its own. It holds because each kernel
# on the path is chosen from the shapes alone and reduces in a fixed
# order, and the data and the init come from the seed.


@contextlib.contextmanager
def torch_default_numerics(torch):
    """torch's own defaults for cuDNN and matmul (TF32 in cuDNN, no
    deterministic algorithms), as a CLI subprocess runs: (b) trains with
    the settings (c)'s job has."""
    keep = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.deterministic,
            torch.backends.cudnn.benchmark)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = keep


def platform_env_checks(card, dev="cuda"):
    """(a) ``collect_env`` names the card; ``run_diagnosis`` on the card
    gives ``device`` OK with the card's name and ``tcp`` OK (the ``grpc``
    line is reported as it comes: it needs grpcio on the card's host). The
    echoes bind free ports, never the fixed defaults another process on
    the host may hold."""
    import torch

    from fedml_tpu_torch.utils.collect_env import collect_env
    from fedml_tpu_torch.utils.diagnosis import run_diagnosis
    on_card = str(dev).startswith("cuda")
    t0 = time.perf_counter()
    env = collect_env()
    env_s = time.perf_counter() - t0
    name = torch.cuda.get_device_name(0) if on_card else "cpu"
    require(("cuda devices:" in env) and (not on_card or name in env),
            f"phase 24 (a): collect_env does not name {name}:\n{env}")
    t0 = time.perf_counter()
    base = free_port_base(4)  # an echo binds base and base + 1
    report = run_diagnosis(device=None if on_card else dev, grpc_port=base,
                           tcp_port=base + 2)
    diag_s = time.perf_counter() - t0
    for k, (ok, detail) in report.items():
        print(f"diagnosis {k:<6} {'OK' if ok else 'FAIL'}  {detail}",
              flush=True)
    require(report["device"][0] and name in report["device"][1],
            f"phase 24 (a): diagnosis device {report['device']}")
    require(report["tcp"][0], f"phase 24 (a): diagnosis tcp {report['tcp']}")
    return {"collect_env_s": env_s, "diagnosis_s": diag_s,
            "env_device_lines": [line for line in env.splitlines()
                                 if line.strip().startswith("- cuda:")],
            "diagnosis": {k: {"ok": ok, "detail": d}
                          for k, (ok, d) in report.items()}}


def _state_of(torch, path):
    """A ``save_model`` artifact as the port's state dict of CPU tensors."""
    import numpy as np

    from fedml_tpu_torch.interop import flax_to_state_dict
    from fedml_tpu_torch.serving import load_model
    return {k: torch.from_numpy(np.array(v))
            for k, v in flax_to_state_dict(load_model(path)).items()}


def platform_train(torch, cb, fa, yml, art, dev="cuda"):
    """(b) ``cli.main(["train", "--cf", yml])`` in this process: exit 0,
    the artifact ``save_model`` wrote equal to the run's params bitwise,
    B1 = 27 x (warm-up + replayed steps + eval batches) with one
    capture."""
    import fedml_tpu_torch
    from fedml_tpu_torch import cli
    on_card = str(dev).startswith("cuda")
    seen = {}
    run_simulation = fedml_tpu_torch.run_simulation

    def recording(*a, **k):  # the run's result, read after the command
        seen["result"] = run_simulation(*a, **k)
        return seen["result"]

    fedml_tpu_torch.run_simulation = recording
    reset_launches(cb, fa)
    t0 = time.perf_counter()
    try:
        with torch_default_numerics(torch):
            rc = cli.main(["train", "--cf", yml]
                          + ([] if on_card else ["--device", str(dev)]))
    finally:
        fedml_tpu_torch.run_simulation = run_simulation
    wall = time.perf_counter() - t0
    b1 = launches(cb, fa)["conv_block"]
    require(rc == 0 and os.path.exists(art),
            f"phase 24 (b): cli train exited {rc}, artifact "
            f"{os.path.exists(art)}")
    res = seen["result"]
    st = res["dispatch_stats"]
    eval_batches = res["history"][-1]["eval_batches"]
    fwd = st["warmup_steps"] + st["replays"] + eval_batches
    saved = _state_of(torch, art)
    require(all(torch.equal(saved[k], v.detach().float().cpu())
                for k, v in res["params"].items()),
            "phase 24 (b): the artifact differs from the run's params")
    if on_card:
        require(st["captures"] == 1 and b1 == 27 * fwd,
                f"phase 24 (b): B1 {b1} != 27 x ({st['warmup_steps']} + "
                f"{st['replays']} + {eval_batches}), {st['captures']} "
                f"captures")
    return {"wall_s": wall, "run_wall_time_s": res["wall_time_s"],
            "test_acc": res["final_test_acc"], "b1_launches": b1,
            "forwards": fwd, "eval_batches": eval_batches,
            **{k: st[k] for k in ("warmup_steps", "replays", "captures",
                                  "capture_s")}}


def platform_agent(torch, yml, art, dev="cuda"):
    """(c) the same yaml through a ``PubSubBroker``, a ``MasterAgent`` and
    a ``SlaveAgent`` in this process (bind token set), dispatched by
    ``launch_job_remote``: the agent's ``api.launch_job`` runs ``python -m
    fedml_tpu_torch.cli train`` as a subprocess on the card; the status
    history ends FINISHED and the artifact exists."""
    from fedml_tpu_torch import api
    from fedml_tpu_torch.agents import (DEVICE_IDLE, JOB_FINISHED,
                                        MasterAgent, SlaveAgent,
                                        launch_job_remote)
    from fedml_tpu_torch.core.distributed.communication.pubsub import \
        PubSubBroker
    on_card = str(dev).startswith("cuda")
    t0 = time.perf_counter()
    broker = PubSubBroker()
    master = MasterAgent("127.0.0.1", broker.port)
    master.start()
    slave = SlaveAgent(PLATFORM_DEVICE_ID, "127.0.0.1", broker.port,
                       poll_s=0.1, device=None if on_card else str(dev))
    slave.start()
    try:
        require(master.wait_for_device(PLATFORM_DEVICE_ID, DEVICE_IDLE,
                                       timeout_s=30) == DEVICE_IDLE,
                "phase 24 (c): the agent never came online")
        up_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        info = launch_job_remote(yml, PLATFORM_DEVICE_ID, master,
                                 timeout_s=PLATFORM_JOB_S)
        dispatch_s = time.perf_counter() - t1
    finally:
        slave.stop()
        master.stop()
        broker.stop()
    history = [h["status"] for h in info.get("history", [])]
    logs = api.run_logs(info["run_id"]) if info.get("run_id") else []
    require(info["status"] == JOB_FINISHED and history
            and history[-1] == JOB_FINISHED and os.path.exists(art),
            f"phase 24 (c): job {info['status']}, statuses {history}; "
            f"log tail: {logs[-20:]}")
    meta = api._read_meta(info["run_id"])
    summary = json.loads(logs[-1])
    return {"agent_up_s": up_s, "dispatch_s": dispatch_s,
            "subprocess_s": meta["ended"] - meta["started"],
            "job_run_wall_time_s": summary["wall_time_s"],
            "test_acc": summary["final_test_acc"], "statuses": history,
            "cmd": meta["cmd"]}


def platform_serve(torch, cb, fa, art, cfg, x, dev="cuda"):
    """(d) ``api.model_serve`` of (c)'s artifact: ``/ready``, then a POST
    ``/predict`` of ``x`` (32 test images), the outputs bitwise those of
    ``CheckpointPredictor.from_files`` on the same device, 27 B1 launches
    per forward on each."""
    import urllib.request

    from fedml_tpu_torch import api
    from fedml_tpu_torch.arguments import Arguments
    from fedml_tpu_torch.serving import CheckpointPredictor
    on_card = str(dev).startswith("cuda")
    body = {"inputs": x.cpu().tolist()}
    t0 = time.perf_counter()
    runner = api.model_serve(art, cfg["model"], 10, dataset=cfg["dataset"],
                             device=None if on_card else str(dev),
                             precision=cfg["precision"],
                             fused_conv_block=cfg["fused_conv_block"])
    try:
        base = f"http://127.0.0.1:{runner.port}"
        with urllib.request.urlopen(base + "/ready", timeout=60) as r:
            require(json.load(r)["ready"] is True, "phase 24 (d): not ready")
        up_s = time.perf_counter() - t0
        reset_launches(cb, fa)
        t1 = time.perf_counter()
        req = urllib.request.Request(
            base + "/predict", data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            served = json.load(r)
        predict_s = time.perf_counter() - t1
        served_b1 = launches(cb, fa)["conv_block"]
    finally:
        runner.stop()
    pred = CheckpointPredictor.from_files(Arguments(**cfg), art, 10,
                                          device=dev)
    reset_launches(cb, fa)
    direct = pred.predict(body)
    direct_b1 = launches(cb, fa)["conv_block"]
    out = torch.tensor(served["outputs"])
    require(tuple(out.shape) == (x.shape[0], 10)
            and torch.isfinite(out).all().item(),
            f"phase 24 (d): outputs of shape {tuple(out.shape)}")
    require(served == direct, "phase 24 (d): the served outputs differ "
                              "from the direct predictor's")
    if on_card:
        require(served_b1 == direct_b1 == 27,
                f"phase 24 (d): B1 {served_b1} served, {direct_b1} direct, "
                f"27 each expected")
    return {"serve_up_s": up_s, "predict_s": predict_s,
            "images": int(x.shape[0]), "b1_launches_served": served_b1,
            "b1_launches_direct": direct_b1, "bitwise_equal": True}


def platform_phase(torch, cb, fa, card, tmp, dev="cuda", cfg=None):
    """Phase 24: (a) env and diagnosis, (b) ``cli train`` in this process,
    (c) the same yaml dispatched through an agent (a CLI subprocess), held
    bitwise to (b), (d) its artifact served over HTTP, bitwise the direct
    predictor."""
    import yaml as _yaml

    from fedml_tpu_torch import data, model
    from fedml_tpu_torch.arguments import Arguments
    cfg = dict(cfg or PLATFORM_PATH)
    t0 = time.perf_counter()
    rec = {"card": card, "env": platform_env_checks(card, dev)}
    pdir = os.path.join(tmp, "platform")
    os.makedirs(pdir, exist_ok=True)
    art = os.path.join(pdir, "model.fmtpu")
    yml = os.path.join(pdir, "job.yaml")
    with open(yml, "w") as f:
        _yaml.safe_dump(dict(cfg, save_model_path=art), f)
    rec["train"] = platform_train(torch, cb, fa, yml, art, dev)
    train_art = os.path.join(pdir, "train.fmtpu")
    os.replace(art, train_art)
    from unittest import mock

    # the agent's bind token and the run registry in tmp, for this process
    # and the jobs it starts
    with mock.patch.dict(os.environ, {
            "FEDML_TPU_AGENT_SECRET": "chip-smoke-bind-token",
            "FEDML_TPU_RUNS_DIR": os.path.join(tmp, "runs")}):
        rec["agent"] = platform_agent(torch, yml, art, dev)
    # the round's start and 32 test images, from the yaml's seed
    args = Arguments(**cfg)
    fed, n_classes = data.load(args)
    p0 = model.create(args, n_classes, fed.input_shape).init(
        torch.Generator().manual_seed(int(cfg["random_seed"])), "cpu")
    pb, pc = _state_of(torch, train_art), _state_of(torch, art)
    moved = max(float((pb[k] - p0[k].float()).abs().max()) for k in pb)
    diff = max(float((pc[k] - pb[k]).abs().max()) for k in pb)
    require(moved > 0 and diff == 0,
            f"phase 24 (c): the agent's params off (b)'s by {diff:.3e}, "
            f"{diff / max(moved, 1e-30):.3e} of the update {moved:.3e} "
            f"(held bitwise)")
    rec["agent"].update(vs_train_max_abs=diff, update_max_abs=moved,
                        vs_train_of_update=diff / moved)
    x = torch.from_numpy(fed.test["x"][0][:BATCH])
    rec["serve"] = platform_serve(torch, cb, fa, art, cfg, x, dev)
    rec["phase_s"] = time.perf_counter() - t0
    return rec


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
    r18_err = r18_err16 = None
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
    for (h, cin, cout, s), _ in RESNET18:
        shape = (BATCH, h, h, cin, cout, s)
        k = cb.cluster_for(BATCH, h, h, cout, s)
        require(k == 8, f"ResNet-18 stage 0: cluster {k}, expected 8")
        r18_err, gerr, r18_err16 = check_case(torch, cb, gen, shape,
                                              "bfloat16")
        print(f"check bfloat16 n,h,w,cin,cout,s={shape} (ResNet-18 stage 0, "
              f"cluster 8): max abs err {r18_err:.3e} (plain bf16: "
              f"{r18_err16:.3e}), grad rel err {gerr:.3e}", flush=True)
        x, p = make_block(torch, gen, *shape, torch.float32, "cuda")
        try:
            cb.fused_block(x, p, strides=s)
        except ValueError as e:
            print(f"check float32 n,h,w,cin,cout,s={shape}: refused as "
                  f"expected ({e})", flush=True)
        else:
            raise SmokeFailure(f"{shape} float32: the kernel took a block "
                               f"whose sample exceeds one CTA's shared "
                               f"memory")
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
    (r18,) = time_geometries(torch, F, cb, gen, "bfloat16", RESNET18)
    per18 = {k: r18[k] * r18["count"]
             for k in ("ms", "device_ms", "plain_ms", "library_ms",
                       "library_event_ms", "bound_ms")}
    print(f"time per ResNet-18 forward (stage 0: 2 blocks "
          f"{r18['geometry']}, bs{BATCH}, bf16, cluster {r18['cluster']}): "
          f"kernel {per18['ms']:.4f} ms (device time "
          f"{per18['device_ms']:.4f} ms), plain {per18['plain_ms']:.4f} ms, "
          f"cuDNN chain device time {per18['library_ms']:.4f} ms (events "
          f"{per18['library_event_ms']:.4f} ms), bound "
          f"{per18['bound_ms']:.5f} ms ({r18['bound_by']})", flush=True)
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
    leg_scale = MAIN_PATH["synthetic_size"] / FLAGSHIP_LEG_SAMPLES
    scaffold, scaffold_launches = scaffold_flagship(torch, cb, fa)
    print(f"SCAFFOLD flagship ({card}): {scaffold['rounds_per_hour']:.2f} "
          f"rounds/hour ({scaffold['step_time_s']:.3f} s per round, "
          f"{scaffold['ms_per_local_step']:.2f} ms per local step) beside "
          f"FedAvg's {record['value'] * leg_scale:.2f} above scaled to its "
          f"{FLAGSHIP_LEG_SAMPLES:,} samples; capture "
          f"{scaffold['capture_s']:.2f} s, "
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
              f"beside FedAvg's {record['value'] * leg_scale:.2f} (scaled "
              f"to {FLAGSHIP_LEG_SAMPLES:,} samples); attack + defense + "
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

    fleet, fleet_launches = fleet_phase(torch, llm, cb, fa, Arguments,
                                        result["adapter_export"], tmp)
    chaos = fleet["chaos"]
    for leg, r in chaos["legs"].items():
        print(f"serving chaos {leg:12s} ({card}): goodput "
              f"{r['goodput_tokens_per_s']:.1f} tokens/s, success rate "
              f"{r['success_rate']:.3f}, injected {r['injected_faults']}, "
              f"resets {r['engine_resets']}, watchdog trips "
              f"{r['watchdog_trips']}, {r['wall_s']:.2f} s", flush=True)
    print(f"serving chaos on/off goodput {chaos['vs_baseline']:.2f}; "
          f"recovery-on outputs equal to the chaos-free leg's: "
          f"{chaos['recovery_on_outputs_equal_chaos_free']} of "
          f"{chaos['requests']}", flush=True)
    for leg, r in fleet["legs"].items():
        print(f"fleet {leg} ({card}): {r['tokens_per_s']:.1f} tokens/s, "
              f"TTFT mean {r['ttft_mean_s']:.3f} s p99 {r['ttft_p99_s']:.3f}"
              f" s, success {r['success_rate']:.3f} (post-loss "
              f"{r['post_loss_success_rate']:.3f}), suffix hits "
              f"{r['suffix_hits']}, prefix hit rate "
              f"{r['prefix_hit_rate']:.3f}, scale events "
              f"{r['scale_events']}, connection drops "
              f"{r['injected_conn_drops']}, replicas at the end "
              f"{r['replicas_end']}, routes {r['routes']}", flush=True)
    fleet["card"] = card
    print(json.dumps({"fleet": fleet}), flush=True)

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

    zoo, zoo_launches = zoo_phase(torch, cb, fa, tmp)
    for label, r in zoo["checks"].items():
        print(f"zoo check {label:12s} (card vs CPU, f32): {json.dumps(r)}",
              flush=True)
    for leg, r in zoo["resnet18"].items():
        print(f"zoo resnet18 {leg:5s} ({card}): {r['rounds_per_hour']:.2f} "
              f"rounds/hour ({r['step_time_s']:.3f} s per round, "
              f"{r['ms_per_local_step']:.2f} ms per local step), "
              f"{r['tflops']:.2f} TFLOP/s, MFU {r['mfu']}, vs_baseline "
              f"{r['vs_baseline']:.2f}; data {r['data_bytes']} bytes, model "
              f"{r['model_bytes']} bytes; B1 {r['b1_launches']} launches = "
              f"{r['b1_per_forward']:.0f} per forward, {r['captures']} "
              f"capture", flush=True)
    for name in ("shakespeare_fedopt", "digits_time_to_acc"):
        r = zoo[name]
        print(f"zoo {name} ({card}): {r['rounds_per_hour']:.1f} rounds/hour "
              f"({r['round_s']:.4f} s per round), final acc "
              f"{r['final_acc']:.4f}, {r['rounds_to_target']} rounds and "
              f"{r['time_to_target_s']} s to {r['target_acc']}, "
              f"{r['data_provenance']} data", flush=True)
    zoo["card"] = card
    print(json.dumps({"zoo": zoo}), flush=True)

    cs, cs_silo_b1, cs_server_b1 = cross_silo_phase(torch, cb, fa, fedml,
                                                    tmp)
    for label, r in cs["checks"].items():
        print(f"cross-silo check {label} (f32): {json.dumps(r)}", flush=True)
    w = cs["wire"]
    print(f"cross-silo wire bench ({card}): dense "
          f"{w['dense_bytes_per_round']:.1f} vs topk_qsgd "
          f"{w['value']:.1f} model-bearing bytes per round "
          f"({w['vs_baseline']:.2f}x), final acc "
          f"{w['dense_final_acc']:.4f} / {w['compressed_final_acc']:.4f}, "
          f"rounds to {w['target_acc']}: {w['dense_rounds_to_target']} / "
          f"{w['compressed_rounds_to_target']}, wall "
          f"{w['dense_wall_s']:.2f} / {w['compressed_wall_s']:.2f} s; legs "
          f"{w['legs']}", flush=True)
    f = cs["flagship"]
    print(f"cross-silo flagship ({card}): {f['s_per_round']:.3f} s per "
          f"round (wall) over {f['timed_rounds']} timed rounds = "
          f"{f['rounds_per_hour']:.2f} rounds/hour (server wait "
          f"{f['wait_s_per_round']:.3f} s, aggregate "
          f"{f['aggregate_s_per_round']:.4f} s, broadcast "
          f"{f['broadcast_s_per_round']:.4f} s, eval "
          f"{f['eval_s_per_round']:.3f} s, the rest "
          f"{f['other_s_per_round']:.3f} s per round); model bytes per round "
          f"S2C {f['s2c_model_bytes_per_round']:.0f}, C2S "
          f"{f['c2s_model_bytes_per_round']:.0f}; test acc "
          f"{f['test_acc']:.4f}; server B1 {f['server_b1_launches']}, HBM "
          f"peak {f['server_hbm_peak_gb']:.2f} GB above what the process "
          f"held before; {f['wall_s']:.1f} s with the silos' start",
          flush=True)
    for r in f["silos"]:
        print(f"cross-silo silo {r['rank']} ({card}): steps "
              f"{r['steps_per_round']}, {r['ms_per_local_step']:.2f} ms per "
              f"local step (timed rounds, the card shared by 4 silos), train "
              f"s per round {[round(x, 3) for x in r['train_s_per_round']]}, "
              f"{r['captures']} capture ({r['capture_s']:.2f} s), B1 "
              f"{r['b1_launches']} launches = 27 x ({r['warmup_steps']} + "
              f"{r['replays']}), HBM peak {r['hbm_peak_gb']:.2f} GB",
              flush=True)
    cs["card"] = card
    print(json.dumps({"cross_silo": cs}), flush=True)

    acs, acs_silo_b1, acs_server_b1 = async_cross_silo_phase(torch, cb, fa,
                                                            fedml, tmp)
    for label, r in acs["checks"].items():
        print(f"async cross-silo check {label} (f32): {json.dumps(r)}",
              flush=True)
    f = acs["flagship"]
    print(f"async cross-silo flagship ({card}): {f['s_per_pour']:.3f} s per "
          f"pour (wall) over {f['timed_pours']} timed pours of K "
          f"{f['k']} = {f['updates_per_hour']:.1f} updates per wall hour "
          f"(sync, phase 16 (c): 4 x "
          f"{cs['flagship']['rounds_per_hour']:.2f} = "
          f"{4 * cs['flagship']['rounds_per_hour']:.1f}); server wait "
          f"{f['wait_s_per_pour']:.3f} s, aggregate "
          f"{f['aggregate_s_per_pour']:.4f} s, eval "
          f"{f['eval_s_per_pour']:.4f} s, broadcast "
          f"{f['broadcast_s_per_pour']:.4f} s, the rest "
          f"{f['other_s_per_pour']:.4f} s per pour; staleness "
          f"{f['staleness_histogram']}; the store {f['store_objects']} "
          f"objects, {f['store_bytes']} bytes; test acc "
          f"{f['test_acc']:.4f}; server B1 {f['server_b1_launches']}; "
          f"{f['wall_s']:.1f} s with the silos' start", flush=True)
    for r in f["silos"]:
        per_step = ("no training after the first"
                    if r["ms_per_local_step"] is None else
                    f"{r['ms_per_local_step']:.2f} ms per local step (after "
                    f"the first)")
        print(f"async cross-silo silo {r['rank']} ({card}): "
              f"{r['trainings']} trainings of {r['steps_per_training']} "
              f"steps, {per_step}, {r['captures']} capture "
              f"({r['capture_s']:.2f} s), B1 {r['b1_launches']} launches = "
              f"27 x ({r['warmup_steps']} + {r['replays']})", flush=True)
    acs["card"] = card
    print(json.dumps({"async_cross_silo": acs}), flush=True)

    gossip = gossip_phase(torch, cb, fa, tmp)
    for label, r in gossip["checks"].items():
        print(f"scenario check {label} (f32): {json.dumps(r)}", flush=True)
    f = gossip["flagship"]
    print(f"gossip flagship ({card}): {f['s_per_round']:.3f} s per round "
          f"(wall) over {f['timed_rounds']} timed round = "
          f"{f['rounds_per_hour']:.2f} rounds/hour; N2N bytes per round "
          f"{f['n2n_bytes_per_round']:.0f}; consensus distance "
          f"{f['consensus_dist']:.4f}; average model's test acc "
          f"{f['test_acc']:.4f}; node 0's eval B1 {f['b1_launches_eval']}; "
          f"{f['wall_s']:.1f} s with the nodes' start", flush=True)
    for r in f["nodes"]:
        print(f"gossip node {r['rank']} ({card}): steps "
              f"{r['steps_per_round']}, {r['ms_per_local_step']:.2f} ms per "
              f"local step (timed round, the card shared by 4 nodes), train "
              f"s {[round(x, 3) for x in r['train_s_per_round']]}, send s "
              f"{[round(x, 3) for x in r['send_s_per_round']]}, wait s "
              f"{[round(x, 3) for x in r['wait_s_per_round']]}, decode s "
              f"{[round(x, 4) for x in r['decode_s_per_round']]}, mix s "
              f"{[round(x, 4) for x in r['mix_s_per_round']]}, "
              f"{r['captures']} capture ({r['capture_s']:.2f} s), B1 "
              f"{r['b1_launches']} training launches = 27 x "
              f"({r['warmup_steps']} + {r['replays']}), "
              f"{r['b1_eval_launches']} in its evaluation, HBM peak "
              f"{r['hbm_peak_gb']:.2f} GB", flush=True)
    gossip["card"] = card
    print(json.dumps({"gossip": gossip}), flush=True)

    sec = secagg_phase(torch, cb, fa, tmp)
    f = sec["field"]
    print(f"secagg field math ({card}): {f['pairs']} pairs of ff_add / "
          f"ff_sub / ff_neg / ff_mul, quantize / dequantize over D = "
          f"{f['d']}, sum_mod_p over [4, D] and [64, D], ff_random: card = "
          f"CPU = integer reference bitwise", flush=True)
    for fo in ("SA", "LSA"):
        f = sec["flagship_sessions"]
        if isinstance(f, str):
            print(f"secagg {fo} session at the flagship's width: {f}",
                  flush=True)
            continue
        f = f[fo]
        print(f"secagg {fo} session at the flagship's width ({card}): 4 "
              f"silos x {SECAGG_STEPS} steps, 1 round, {f['wall_s']:.2f} "
              f"s; B1 {f['b1_launches']} = 27 x ({f['warmup_steps']} + "
              f"{f['replays']} + {f['eval_batches']} eval batches); vs "
              f"plain FedAvg of its silos' deltas {f['within_tolerance']:.4f}"
              f" of the tolerance ({f['clipped_coordinates']} coordinates "
              f"clipped)", flush=True)
    f = sec["algebra"]
    if not isinstance(f, str):
        print(f"secagg algebra over the SA session's deltas ({card}): D = "
              f"{f['d']}; delta + quantize on the card "
              f"{f['delta_quantize_ms_per_client']:.2f} ms per client; "
              f"masking on the host {f['mask_s_per_client']:.3f} s per "
              f"client; unmask {f['unmask_s_0_dropped']:.3f} s with 0 "
              f"dropped, {f['unmask_s_1_dropped']:.3f} s with 1; LSA encode "
              f"{f['lsa']['encode_s_per_client']:.3f} s per client, decode "
              f"{f['lsa']['decode_s_0_dropped']:.3f} / "
              f"{f['lsa']['decode_s_1_dropped']:.3f} s; every unmasked sum "
              f"= the survivors' plain quantized sum bitwise", flush=True)
    print(f"secagg sessions: {json.dumps(sec['sessions'])}", flush=True)
    sec["card"] = card
    print(json.dumps({"secure_aggregation": sec}), flush=True)

    roof, roof_b1 = roofline_phase(torch, llm, cb, fa, Arguments, card)
    f = roof["flagship"]
    print(f"roofline flagship step ({card}): {f['ops']} ops, "
          f"{f['b1_rows']} B1 rows (27 per forward, each = block_cost), "
          f"conv + matmul {f['registry_flops']:.6e} FLOPs = "
          f"FlopCounterMode's; predicted {f['predicted_ms_per_step']:.4f} "
          f"ms per step vs measured {f['measured_ms_per_step']:.4f} ms "
          f"(CUDA events over {ROOFLINE_STEP_REPLAYS} graph replays), "
          f"predicted MFU {f['predicted_mfu']}, memory-bound share "
          f"{f['memory_bound_share']}; {f['steps']} steps in the round, B1 "
          f"{roof_b1['conv_block']} launches; recompile at batch 16: "
          f"{json.dumps(f['recompile']['changed'][:2])}", flush=True)
    lm = roof["llm"]
    print(f"roofline LLM ({card}): hot step kernel rows "
          f"{lm['hot_step_kernel_rows']} (= attention_cost), predicted "
          f"{lm['hot_step']['predicted_s'] * 1e3:.3f} ms, MFU "
          f"{lm['hot_step']['predicted_mfu']}; serving records "
          f"{lm['serving_records']} over {ROOFLINE_DECODE_STEPS + 1} "
          f"decode steps at 64 slots ({lm['decode_step_ms_64_slots']:.3f} "
          f"ms each after the first); dispatch_signature {lm['signature_us_per_dispatch']:.2f}"
          f" us per dispatch ({lm['signature_leaves']} leaves, "
          f"{lm['signature_share_of_step'] * 100:.3f} % of a step)",
          flush=True)
    print(json.dumps({"roofline": roof}), flush=True)

    cd = cross_device_phase(torch, cb, fa, tmp, card)
    for leg in ("flagship", "compressed"):
        f = cd[leg]
        print(f"cross-device {leg} ({card}): 4 ResNet-56 devices x "
              f"{CD_STEPS} steps, 1 round: {f['round_s']:.3f} s (wait "
              f"{f['wait_s']:.3f}, aggregate {f['aggregate_s']:.4f}, eval "
              f"{f['eval_s']:.3f}), {f['wall_s']:.2f} s with the devices' "
              f"start; B1 {f['b1_launches']} = 27 x ({f['warmup_steps']} + "
              f"{f['replays']} + {f['eval_batches']} eval batches); vs the "
              f"uploads' weighted mean {f['within_tolerance']:.4f} of the "
              f"tolerance; uploads {f['upload_bytes']} bytes", flush=True)
    print(f"cross-device native leg ({card}): on-device evals "
          f"{cd['native']['cuda']['device_eval_acc']} (card), "
          f"{cd['native']['cpu']['device_eval_acc']} (CPU); the native "
          f"device's artifact the same bytes on both", flush=True)
    print(json.dumps({"cross_device": cd}), flush=True)

    mr = multi_rank_phase(torch, cb, fa, card)
    for name, leg in mr["client_axis"]["legs"].items():
        st = leg["stats"]
        extra = ("" if "allreduce_ms" not in leg else
                 f"; all-reduce {st['allreduce_bytes']} bytes in "
                 f"{st['allreduce_calls']} call(s), {leg['allreduce_ms']:.3f}"
                 f" ms alone, {leg['staged_bytes']} bytes staged through "
                 f"the host")
        print(f"multi-rank client axis {name} ({card}): {leg['wall_s']:.2f} "
              f"s for 1 round of 8 ResNet-56 clients (capture included); B1 "
              f"{leg['b1_launches']} = 27 x {leg['b1_forwards']}{extra}",
              flush=True)
    print(f"multi-rank client axis: NCCL 1 rank = plain engine bitwise; 2 "
          f"gloo ranks bitwise equal, "
          f"{mr['client_axis']['vs_one_rank_of_tolerance']:.4f} of the "
          f"house tolerance from 1 rank", flush=True)
    for r, ring in enumerate(mr["ring"]):
        print(f"multi-rank ring attention rank {r} (sp 2, b,s,h,d="
              f"{RING_SHAPE}): " + "; ".join(
                  f"{k} {['%.2e' % e for e in v['rel_err_o_dq_dk_dv']]}"
                  for k, v in ring.items() if isinstance(v, dict)
                  and "rel_err_o_dq_dk_dv" in v)
              + f"; model forward {ring['model_forward_rel_err']:.2e}; "
              f"staged {ring['collectives']['staged_bytes']} bytes",
              flush=True)
    for r, sh in enumerate(mr["sharded"]):
        for shape, leg in sh.items():
            print(f"multi-rank sharded step (NCCL rank {r}) {shape}: loss "
                  f"{leg['loss']:.6f} (off {leg['loss_err']:.1e}), params off"
                  f" {leg['param_err']:.1e}, {leg['step_s']:.2f} s, "
                  f"launches {leg['launches']}", flush=True)
    for where, sh in [("NCCL rank 0", mr["sharded_lora"]["nccl_1"])] + [
            (f"gloo rank {r}", x)
            for r, x in enumerate(mr["sharded_lora"]["gloo_2"])]:
        for shape, leg in sh.items():
            print(f"multi-rank sharded step + LoRA ({where}) {shape}: "
                  f"{leg['adapters']} factors, loss off {leg['loss_err']:.1e}"
                  f", params off {leg['param_err']:.1e} (factors "
                  f"{leg['adapter_err']:.1e}), launches {leg['launches']}",
                  flush=True)
    for leg, r in mr["robust"].items():
        extra = ("" if leg == "async" else
                 f"; all-to-all {r['all_to_all_calls']} call(s), "
                 f"{r['all_to_all_bytes']} bytes, wire "
                 f"{r['all_to_all_wire_bytes']}, "
                 f"{['%.2f' % m for m in r['all_to_all_ms']]} ms, staged "
                 f"{r['staged_bytes']}; defense input "
                 f"{r['defense_input_other_share']:.2e} elsewhere")
        print(f"multi-rank robust {leg} ({card}): ranks "
              f"{['%.2f' % w for w in r['ranks_wall_s']]} s, one rank "
              f"{r['one_rank_wall_s']:.2f} s, "
              f"{r['vs_one_rank_of_tolerance']:.4f} of the house tolerance "
              f"from 1 rank{extra}", flush=True)
    print(json.dumps({"multi_rank": mr}), flush=True)

    tail = tail_phase(torch, cb, fa, card)
    worst = max(max(r["logits"], r["grads"]) for k, r in
                tail["models"].items() if isinstance(r, dict))
    print(f"tail models ({card}): {len(tail['models']) - 1} models card vs "
          f"CPU, worst {worst:.4f} of the house tolerance; bf16 "
          f"MobileNetV3-Small {tail['models']['mobilenet_bf16_vs_f32']:.4f} "
          f"of its largest f32 logit (bound {TAIL_BF16_BOUND})", flush=True)
    for name, r in tail["protocols"].items():
        a = r["all_rounds"]
        print(f"tail {name} ({card}): {r['rounds']} rounds card "
              f"{r['card_s']:.2f} s / CPU {r['cpu_s']:.2f} s; after "
              f"{r['gated_rounds']} (held): params "
              f"{r['params_of_tolerance']:.4f}, history "
              f"{r['history_of_tolerance']:.4f} of the tolerance, accuracy "
              f"off {r['acc_diff']:.4f}; after {r['rounds']} (reported): "
              f"params {a['params_of_tolerance']:.4f}, history "
              f"{a['history_of_tolerance']:.4f}, accuracy off "
              f"{a['acc_diff']:.4f}; {r['final']}", flush=True)
    fm = tail["femnist"]
    print(f"tail hierarchical FEMNIST ({card}): MobileNetV3-Small bf16, 24 "
          f"clients, 4 groups x 2 edge rounds: {fm['s_per_global_round']:.3f}"
          f" s per global round, hierarchical_femnist_mobilenet_rounds_per_"
          f"hour {fm['hierarchical_femnist_mobilenet_rounds_per_hour']:.2f}"
          f" (warm-up round {fm['warmup_round_s']:.2f} s)", flush=True)
    tb, ce = tail["full_width"]["turbo"], tail["full_width"]["centralized"]
    print(f"tail turbo_aggregate ({card}): ResNet-56 bf16 + B1, 8 of 64 "
          f"clients in 2 groups, 1 round {tb['s_per_round']:.2f} s (capture "
          f"{tb['capture_s']:.2f} s); vs plain FedAvg: aggregate "
          f"{tb['agg_vs_fedavg']:.3e}, model {tb['model_vs_fedavg']:.3e} "
          f"(bound {tb['quanta_bound']:.3e}); B1 {tb['b1_launches']} = 27 x "
          f"({tb['warmup_steps']} + {tb['replays']} + {tb['eval_batches']})",
          flush=True)
    print(f"tail centralized ({card}): ResNet-56 bf16 + B1, {ce['steps']} "
          f"steps {ce['s_per_epoch']:.2f} s (capture {ce['capture_s']:.2f} "
          f"s), {ce['s_per_step'] * 1e3:.3f} ms per step; B1 "
          f"{ce['b1_launches']} = 27 x ({ce['warmup_steps']} + "
          f"{ce['replays']} + {ce['eval_batches']}); phase 23 "
          f"{tail['phase_s']:.1f} s", flush=True)
    print(json.dumps({"tail": tail}), flush=True)

    plat = platform_phase(torch, cb, fa, card, tmp)
    pt, pa, ps = plat["train"], plat["agent"], plat["serve"]
    print(f"platform cli train ({card}): ResNet-56 bf16 + B1, 8 clients x "
          f"2,048 samples, 1 round: {pt['wall_s']:.2f} s in process (run "
          f"{pt['run_wall_time_s']:.2f} s, capture {pt['capture_s']:.2f} s); "
          f"B1 {pt['b1_launches']} = 27 x ({pt['warmup_steps']} + "
          f"{pt['replays']} + {pt['eval_batches']})", flush=True)
    print(f"platform agent job ({card}): dispatch to FINISHED "
          f"{pa['dispatch_s']:.2f} s, the CLI subprocess "
          f"{pa['subprocess_s']:.2f} s (its run {pa['job_run_wall_time_s']:.2f} s); params off the "
          f"in-process run by {pa['vs_train_of_update']:.3e} of the round's "
          f"update (held bitwise)", flush=True)
    print(f"platform serve ({card}): up {ps['serve_up_s']:.2f} s, /predict "
          f"of {ps['images']} images {ps['predict_s'] * 1e3:.1f} ms, bitwise "
          f"the direct predictor; B1 {ps['b1_launches_served']} per forward; "
          f"phase 24 {plat['phase_s']:.1f} s", flush=True)
    print(json.dumps({"platform": plat}), flush=True)

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
        "launches_fleet": fleet_launches["conv_block"],
        # phase 16 (c): the 4 silo processes' captured steps, and the
        # server's evaluations
        "launches_cross_silo_silos": cs_silo_b1,
        "launches_cross_silo_server": cs_server_b1,
        # phase 17 (b): the buffered-async session's 4 silo processes and
        # the server's evaluations
        "launches_async_cross_silo_silos": acs_silo_b1,
        "launches_async_cross_silo_server": acs_server_b1,
        # phase 18 (b): the 4 gossip node processes' captured steps, and
        # node 0's evaluation of the average model
        "launches_gossip_nodes": gossip["flagship"]["b1_launches_nodes"],
        "launches_gossip_eval": gossip["flagship"]["b1_launches_eval"],
        # phase 19 (b): the SA and LSA sessions at the flagship's width
        # (their silos' captured steps and the server's evaluation)
        "launches_secagg_sa": (None if isinstance(sec["flagship_sessions"],
                                                  str) else
                               sec["flagship_sessions"]["SA"]["b1_launches"]),
        "launches_lightsecagg": (
            None if isinstance(sec["flagship_sessions"], str) else
            sec["flagship_sessions"]["LSA"]["b1_launches"]),
        # phase 20 (a): the round the roofline observed (the captures'
        # launches are counted apart, 27 per capture of the step)
        "launches_roofline_round": roof_b1["conv_block"],
        "roofline_rows_per_forward": roof["flagship"]["b1_rows"],
        # phase 21: the cross-device sessions at the flagship's width
        "launches_cross_device": cd["flagship"]["b1_launches"],
        "launches_cross_device_compressed":
            cd["compressed"]["b1_launches"],
        # phase 22 (a): the plain engine, the NCCL rank and each gloo rank
        "launches_multi_rank_plain": mr["b1_launches_plain"],
        "launches_multi_rank_nccl_1": mr["b1_launches_nccl_1"],
        "launches_multi_rank_ranks": mr["b1_launches_ranks"],
        # phase 22 (d), (e): the defended and buffered-async runs over
        # the two gloo ranks and on one rank
        "launches_multi_rank_robust": {
            leg: {k: v for k, v in r.items() if k.startswith("b1_")}
            for leg, r in mr["robust"].items()},
        # phase 23 (d): turbo_aggregate and the centralized trainer at the
        # flagship's widths
        "launches_turbo_aggregate": tb["b1_launches"],
        "launches_centralized": ce["b1_launches"],
        # phase 24: the CLI's in-process training run and the served
        # artifact's one forward
        "launches_platform_train": pt["b1_launches"],
        "launches_platform_serve": ps["b1_launches_served"],
        "max_abs_err": main_err,
        "max_abs_err_plain_bf16": main_err16,
        "ms": per_fwd["ms"], "plain_ms": per_fwd["plain_ms"],
        "bound_ms": per_fwd["bound_ms"], "bound_by": per_fwd["bound_by"],
        "library_ms": per_fwd["library_ms"],
        "device_ms": per_fwd["device_ms"],
        "clusters": {r["geometry"]: r["cluster"] for r in rows},
        # ResNet-18's stage 0 (2 blocks per forward; phase 15)
        "launches_resnet18": zoo_launches["fused"]["conv_block"],
        "launches_resnet18_cudnn": zoo_launches["cudnn"]["conv_block"],
        "max_abs_err_resnet18": r18_err,
        "max_abs_err_plain_bf16_resnet18": r18_err16,
        "ms_resnet18": per18["ms"], "device_ms_resnet18": per18["device_ms"],
        "plain_ms_resnet18": per18["plain_ms"],
        "library_ms_resnet18": per18["library_ms"],
        "bound_ms_resnet18": per18["bound_ms"],
        "bound_by_resnet18": r18["bound_by"],
        "cluster_resnet18": r18["cluster"],
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
            "launches_fleet": fleet_launches[name],
            # phase 20 (b): rows in the hot step's roofline (those
            # launches are the capture's, not counted)
            "roofline_rows_hot_step":
                roof["llm"]["hot_step_kernel_rows"].get(name, 0),
            # phase 22 (c): each rank's launches in each sharded step
            "launches_sharded_step_ranks": {
                shape: [sh[shape]["launches"][name] for sh in mr["sharded"]]
                for shape in mr["sharded"][0]},
            "launches_sharded_lora_step_ranks": {
                shape: [sh[shape]["launches"][name] for sh in
                        [mr["sharded_lora"]["nccl_1"]]
                        + mr["sharded_lora"]["gloo_2"] if shape in sh]
                for shape in (json.dumps(SHARDED_MESH_ONE),
                              json.dumps(SHARDED_MESH_TP2))},
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
