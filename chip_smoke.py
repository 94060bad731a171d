#!/usr/bin/env python3
"""On-card smoke test of ray_tpu_torch, the PyTorch / CUDA port.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. device  — the card's name and power limit (nvidia-smi) and torch's name;
  2. build   — compile every CUDA kernel from ray_tpu_torch/ops/csrc, and
     count the tensor-core instructions (HMMA / HGMMA, by cuobjdump) of the
     bf16 forward kernel, of the bf16 dQ and dK/dV kernels, of K1's bf16
     suffix kernel and of every profiling kernel (K8-K10): none fails the
     run; every function of K8's, K9's and K10's libraries must hold HGMMA
     (wgmma) and UTMALDG (TMA loads) and no HMMA;
  3. kernels — hold each kernel against its plain PyTorch version at the
     serving and training paths' GPT-2 125M shapes (H=12, D=64), with stated
     tolerances; time kernel, plain version, the bound and, where one
     PyTorch call computes the same function, that call (a yardstick only);
     K2-K7 rows also print their achieved TFLOP/s, and K2, K3 and K6 the
     time of the CUDA-core kernel they replaced (`earlier_ms`); K3 at the
     trainer's shape also has its two launches timed apart, with its
     workspace and peak memory, and is timed once more at head_dim 128; K3, K4, K5 and K7 run twice on the same inputs and must
     give dq, dk and dv bit for bit, K1 (decode, verify, suffix, every pool
     dtype) its output, whose rows also carry the device time of each of
     its launches (the split kernel and its merge, or a suffix kernel);
  4. profile — the profiling entry points (ray_tpu_torch.profiling:
     attn_dissect, attn_variants, attn_subtile) at the reference scripts'
     B24 S1024 H12 D64 bf16, each with its kernel's launch counter zeroed
     just before and read just after; then every K8 level and the two-head
     variant, every K9 tile and every K10 T against its plain version, each
     run twice (bit for bit), with its share of outputs bit-identical to the
     plain version's and the earlier kernel's time (`earlier_ms`);
  5. train   — GPT-2 125M (bf16 compute on f32 params) takes 5 fused_adamw
     steps at B=8, S=1024 through the packed kernels (K6, K7): finite
     losses that fall, both kernels launched 12 per step, step time,
     tokens/s and the card's busy share under torch.profiler; then the
     long-context branch at B=1, S=4096 (K2, K4, K5) for 2 steps; then f32
     parity of one step (loss, every gradient, the parameters after the
     update) between the kernels and the plain attention path;
  6. trainer — the same model with attention_impl="auto" trains through
     ray_tpu_torch.train.TorchTrainer on a worker actor of the in-process
     runtime (cuda:0): 5 steps at B=8, S=1024 through K2 and the one-block
     backward K3 (12 launches each per step, K4-K7 none), losses that fall,
     a checkpoint of the parameters and both moments; a second fit() resumes
     from it bit for bit and takes step 5; then f32 parity of one "auto"
     step against the plain attention path;
  7. server  — LLMServer serves GPT-2 125M (random seeded weights) to 8
     concurrent requests; asserts they all finish, the prefix cache hit,
     and both kernels launched on that run; the same traffic again under
     torch.profiler gives the card's busy share and K1's kernels' device
     time; then f32 on the kernels must
     be token-identical to f32 on the plain versions, one request at a
     time through the servers and all 8 live together in one batch;
  8. modes   — the serving modes on the same model (bf16 unless said): (a)
     the server phase's traffic with async scheduling off, on, on, off
     (tokens/s, TTFT, step and host-gap p50, the chained share, and at how
     many chained dispatches the step chained from was still running);
     decode_async enqueued on a parked card under torch's sync debug mode;
     (b) ngram k = 4 and a 2-layer draft at k = 8 on a repetitive and a
     random prompt set (acceptance; K1's split and suffix kernels both
     launched by verify at k = 8); (c) async with ngram; (d) in f32, one
     deterministic batch token-identical across the sync kernel path, the
     plain path, async, ngram, a draft with the target's weights (every
     proposal accepted) and async + ngram;
  9. serve   — the same model served through
     serve.run(llm.serve.build_app(...)): two ingress replicas in front of
     one engine actor, and the HTTP proxy, on host weights that land on the
     card once (memory before and after). The server phase's 8 requests at
     once, 4 through the handle and 4 over HTTP (blocking and streaming),
     with K1 and K2 launched; tokens/s, TTFT and step p50 on one `[serve]`
     line beside the in-process server's; then in f32 the 8 requests one at
     a time, token-identical to an in-process server, and a stream whose
     replica is killed after 8 tokens, resumed contiguous and identical;
     the engine's observability and autoscaling snapshots;
 10. loadgen — the same model driven open-loop through Serve by the port's
     loadgen (ray_tpu_torch.loadgen.sweep.run_sweep on the card, at full
     width, on the same host weights): the knob cells base, async_step,
     spec_ngram and int8_kv at 6 requests/s (24 each), the drain cell, the
     collapse cell and the KV-fabric pair (kv_fabric_affinity and
     kv_fabric_p2c: multiturn over two replicas with an engine each on one
     fabric, 12 requests), every gate passing (the pair's: zero drops,
     blocks flushed, a cross-replica fabric hit), K1 launched in every
     cell and K2 in every knob cell (counters set to 0 just before each
     cell's open-loop run, read just after), one `[loadgen]` line a cell
     (the pair's with its repeat wave's TTFT p50); no engine and no
     `kv_fabric:*` store left alive after the cells; base twice more
     (median and spread); then two replicas with an engine each under 24
     requests with live burn-rate monitors, read by fleet_snapshot (each
     replica's ledger covering its wall, its columns, goodput and MFU
     printed), and one request's timeline(trace_id=...);
 11. fabric  — the KV fabric on the server phase's weights: (a) a block
     extracted from a bf16 and an int8 pool and restored into another
     slot, bit for bit, as host numpy of kv_block_bytes() bytes; (b) server
     A serves the server phase's 8 prompts and flushes into the fabric,
     a fresh server B on it serves them from restores (restores > 0 and at
     most sum((n - 1) // bs), no store timeout, K1 launched on B's run,
     neither warmup touching the store; each restoring step's
     fabric_wait_s printed), token-identical to A and to a fabric-off
     engine in f32; (c) DisaggregatedLLM in f32, token-identical to a
     unified engine, K2 launched by the prefill engine and K1 by the
     decode engine, (n - 1) // bs blocks restored a request, its TTFT
     beside the unified engine's; (d) no engine or store left alive, the
     card memory left.
 12. resnet  — ResNet-50 at bench.py's shape (B256 224x224x3, bf16 on f32
     parameters, 1000 classes, GroupNorm, SGD with momentum 0.9, synthetic
     data from a seeded generator on the card) through TorchTrainer.fit() on
     a worker actor on cuda:0: 2 warm-up steps, 10 timed and one profiled;
     finite losses and no attention kernel launched (counters set to 0 just
     before the fit, read just after); step p50, images/s, train TFLOP/s by
     bench.py's 3 x 4.1 GFLOP an image and its share of 989 TFLOP/s, the
     card's busy share and top five kernels, whether any norm's input or
     output gradient was not channels_last, peak memory; then norm="batch"
     for 3 bare steps (running statistics finite and moved), ResNet-18
     small_inputs at B256 32x32 for 5 (images/s), and one f32 step of
     ResNet-18 small_inputs at B4 on the card against the same step on the
     CPU (loss, every gradient, every parameter after it; TF32 off);
 13. moe     — gpt2_125m(num_experts=8) (6 MoE blocks, bf16 experts): (a) 5
     fused_adamw steps at B=8, S=1024 through K6/K7 on CE + the MoE aux
     losses (losses fall, K6 and K7 12 per step), step p50, tokens/s, busy
     share, the aux sum and each MoE layer's dropped share at step 1; f32
     parity of one step against the plain attention path; (b) LLMServer in
     bf16 with the server phase's engine and 8 requests (all finish, the
     prefix cache hits, K1 and K2 launched), tokens/s and TTFT p50 beside
     the dense server's; in f32 the kernels against the plain versions,
     token-identical one request at a time and all 8 live together; (c) the
     card memory left.
 14. tune    — Tune over the trainer: ray_tpu_torch.init with the card as
     the GPU resource; Tuner(TorchTrainer(...)) trials of GPT-2 125M at B8
     S1024 (K2, K3), each holding {"CPU": 1, "GPU": 0.5}, so two run at
     once and a third waits; (a) ASHA over 4 trials (lr loguniform, seeded;
     max_t 6, grace period 1, reduction factor 2): a trial stopped early;
     (b) PBT over 2 trials (lr 0.05 and 3e-4 in a grid, perturbation
     interval 2, 6 iterations, a host checkpoint of the parameters and both
     moments every 2 steps): an exploit that resumes bit for bit from the
     source's checkpoint (torch.equal and the on-card fingerprint). Each
     fit() with the counters set to 0 just before and read just after: K2
     and K3 12 x the steps the loops reported, K4-K7 none; the best trial's
     loss below its first; `[tune]` lines per trial (lr, iterations, final
     loss, stopped early, fit() wall minus the steps' wall) and per exploit.
 15. rllib   — RLlib's PPO and IMPALA (ray_tpu_torch.rllib) at bench.py's
     accelerator shapes, the learner on cuda:0 and the envs and the numpy
     policy forward on the host: (a) PPO on CartPole-v1, 1 runner x 128
     envs, fragment 64, batch 8192, minibatch 256, 4 epochs, 1 warm-up, 5
     timed and 1 profiled train() (the learner's parameters and Adam state
     on cuda:0, the runners' modules on the CPU, finite losses, the last
     iteration's episode_return_mean above the first's; env-steps/s as
     bench_ppo counts them, each update's wall, the sampling wait an
     iteration, the card's busy share of the profiled iteration); (b)
     IMPALA on MinAtar-Breakout, 1 runner x 256 envs, fragment 64, batch
     4096, 1 + 10 train() (learner updates, no learner_error, finite
     losses; env-steps/s, updates an iteration, queue occupancy); no
     attention kernel launched on (a) or (b), counted from 0 just before
     each; (c) f32 card against CPU of one PPO update (2 minibatches) and
     one IMPALA update from the same state (RLLIB_PARITY); (d) two learner
     actors at num_gpus_per_learner=0.5, equal bit for bit after an
     update; (e) save()/restore() bit for bit; (f) a runner sampling with
     sample_device="cuda". `[rllib]` lines carry the card's name and power
     limit.
 16. rllib_algos — the rest of RLlib (ray_tpu_torch.rllib), every learner
     on cuda:0, envs, replay and offline files on the host: (a) DQN on
     CartPole-v1 at DQNConfig's defaults ((256, 256), batch 32, fragment 4,
     1,000 steps before learning, target sync every 500, double-Q), uniform
     replay and n_step=3 prioritized, 3,000 env steps each (parameters,
     Adam state and target on cuda:0, finite losses, priorities moved by
     the TD errors, update p50, env-steps/s, kernel launches an update, the
     card's busy share of one profiled iteration); (b) Ape-X, 2 replay
     shards and 2 runners (shards fill, priorities return, stop() leaves no
     shard actor); (c) SAC and TD3 on Pendulum-v1 at their defaults
     ((256, 256), batch 256, fragment 1, tau 0.005, TD3's policy_delay 2),
     500 updates each (alpha moved; TD3's actor bit for bit unchanged
     across an off tick); (d) APPO at bench_impala's shape and A2C at
     bench_ppo's, 1 + 3 iterations; (e) PPO tees its rollouts to disk and
     BC clones them (its NLL falls), CQL trains from SAC's teed rollouts,
     IS and WIS over the logs are finite; (f) MultiAgentCartPole PPO with a
     shared policy and with two policies (each learner on cuda:0, their
     parameters different); (g) f32 card against CPU of one update of each
     new learner (DQN, SAC, TD3, CQL, A2C, APPO, BC) on the same batch,
     weights and noise, by RLLIB_PARITY. No attention kernel launched on
     any path, each counted from 0 just before it. `[rllib_algos]` lines.
 17. data    — Ray Data (ray_tpu_torch.data) feeding TorchTrainer through
     datasets=: (a) range_tensor(96, shape=(8,)) through
     iter_device_batches(batch_size=32): 3 batches on cuda:0, bit for bit
     iter_batches' host batches, each next batch's copy enqueued (pinned
     memory, a copy stream) before a batch is handed out, by the
     iterator's own order log; (b) GPT-2 125M from a Dataset (seeded int64
     token rows, random_shuffle(seed=0), map_batches into input and
     target) on two workers at half the card each on cuda:0, each reading
     get_dataset_shard("train").iter_device_batches(batch_size=8) for 5
     steps with "auto" attention (no gradient sync between them): K2 and
     K3 12 a step per worker, K4-K7 none, finite losses, the ranks' rows
     disjoint and every row read once, the samples clock at the rows read;
     step p50 beside the trainer phase's, the data_wait share of each
     round, samples/s and data_blame; (c) ResNet-50 at bench.py's shape
     from a Dataset of seeded uint8 HWC images made on the host (38.5 MB a
     batch) through iter_device_batches, scaled into bf16 on the card, 2
     warm-up and 5 timed steps: no attention launch, the first batch's
     checksums on the card equal to the host's, images/s beside the resnet
     phase's and the data_wait share of each step. `[data]` lines.
 18. procs   — GPT-2 125M in GPU actors and tasks that own their worker
     processes and CUDA contexts (ray_tpu_torch.init with
     isolation="process", the memory monitor polling every 0.1 s on an
     injected host-memory fraction): (a) two LLMServer actors at half the
     card each (max_restarts=1) serve the server phase's 8 prompts through
     ActorPool.map_unordered, one prompt at a time from an empty prefix
     cache, token-identical to the in-process server, K1 and K2 launched in
     the children (each actor's counters set to 0 just before and summed
     just after), their pids apart from the driver's; (b) with one actor's
     call in flight the fraction reads 0.99: the monitor kills it, its pid
     is gone and the card's used memory (mem_get_info) falls by at least
     what it held; the fraction falls, the actor restarts in a new process
     and the pool's next map gives the same tokens; (c) a DAG make_tokens
     (host, B8 S1025) -> train (num_gpus=1: 5 bf16 fused_adamw steps through
     K6/K7, the f32 parameters back on the host) -> evaluate (num_gpus=1:
     the held-out loss) run straight, then as a workflow whose evaluate
     fails once: resume() does not run train again (one run, no K6/K7 in
     the resumed children) and gives the straight run's losses and
     evaluation bit for bit; the straight run's two crossings of the
     ~500 MB train result (worker to driver, driver to worker), and the
     step results' bytes and load and save seconds; (d) the trainer
     phase's loop through TorchTrainer on two worker processes at half the
     card: K2 = K3 = 120 over the children, step p50 beside the data
     phase's two thread workers and the trainer phase's one; (e) after
     shutdown() no worker pid is alive and the card's used memory is
     within LEFT_LIMIT_MIB of the phase's start; (f) the same trainer loop
     on two thread workers under a thread runtime, K2 = K3 = 120, its step
     p50 beside (d)'s. `[procs]` lines.
 19. store   — the native shared-memory store, spilling and lineage
     recovery (ray_tpu_torch/_private/native_store.py, external_storage.py,
     runtime.get_value): (0) /dev/shm's free bytes (fatal below what (c)
     needs), the host's available RAM, the spill directory's free disk;
     (a) under isolation="process" phase 18's train (num_gpus=1, K6 + K7)
     returns GPT-2's f32 parameters as one flat 498 MB tensor, which must be
     in shm (is_native) in the driver's store, and evaluate (num_gpus=1,
     "auto", K2) reads it: losses and evaluation bit for bit phase 18's
     straight DAG, the two crossings timed as phase 18 times them, beside
     its frame figures from before the store; again with the vector
     returned on cuda:0 (read back onto the card), and once with
     native_store_enabled=False (the frame path's crossings of the same
     vector, bit for bit the shm path's); the driver's first and second
     read of the vector, and its host-to-device copies (out of the segment
     and from a private copy); (b) a thread runtime with a 1.5 GiB store: five
     f32 GPT-2 125M state dicts put (seeds 0-4) spill the oldest two (the
     storage's stats()), each reads back bit for bit, the spilled seed-0
     dict loaded into an LLMServer gives the server phase's tokens for its
     8 prompts (K1, K2 counted), one spill's and one restore's seconds;
     (c) a CPU worker returns the vector 10 times over (4.98 GB, past the
     u32 frame): through shm to the driver and to a second worker, every
     slice bit for bit, both crossings timed; with the store off the same
     task fails with FrameTooLargeError; (d) in (b)'s runtime train's
     returned state dict and a put dict spill under pressure and their
     spill files are deleted: get re-runs train exactly once (K6/K7 counted
     in that run), bit for bit; the put dict raises ObjectLostError and a
     freed task result ObjectFreedError, re-running nothing; (e) after
     shutdown() no /dev/shm/ray_tpu_torch_* segment, no spill directory and
     no worker pid is left, and the card's memory is back within
     LEFT_LIMIT_MIB of the phase's start. `[store]` lines.
 20. nodes   — GCS persistence and remote nodes (_private/head_server.py,
     remote_node.py, node_daemon.py, object_plane.py, client.py,
     gcs_storage.py): a head in this process with isolation="process", no
     GPU of its own and serve_clients(port=0); two daemons (`python -m
     ray_tpu_torch._private.node_daemon`, nodeA and nodeB, --num-gpus 1,
     2 GiB stores), their start and registration seconds; (a) a GPT-2
     125M server actor at 0.5 GPU on nodeA serves the 8 prompts, each
     alone from an empty prefix cache, token-identical to the server
     phase's (K1, K2 counted in the daemon's worker); a task that imports
     torch leaves a worker in nodeA's pool (its start seconds), so the
     crossings below exclude a worker's start; phase 19's train
     (0.5 GPU on nodeB, K6 + K7) returns the 498 MB vector, on the host
     and then on cuda:0, evaluate (0.5 GPU on nodeA) takes its ref, so
     nodeA's daemon pulls it from nodeB's object server over loopback TCP,
     and the driver's get pulls it to the head: losses bit for bit phase
     18's, the vector phase 19's, each crossing's seconds beside phase
     19's same-node shm figures; (b) a child process with
     init(address=...) finds the server by name, gets the same tokens,
     reads the vector (sha256 equal), sees a daemon worker's line pushed
     by the head; after it exits the head holds none of its borrows; (c)
     train again on nodeB, nodeB's daemon SIGKILLed before anything pulls
     its result: the driver's get re-runs train once on nodeA (K6 = K7
     counted in the re-run), bit for bit; nodeB's workers gone and the
     card's used memory down; (d) head 1 in a process of its own with
     gcs_storage_path, a fixed port and token, a daemon with a 90 s
     reconnect window, a detached server `gpt2` (built from seed 0 in its
     actor) serving the prompts (K1, K2), the snapshot saved (bytes, flush
     seconds); head 1 SIGKILLed: the daemon kills and reaps its workers,
     the card's used memory back within LEFT_LIMIT_MIB of its figure
     before the actor; head 2 on the same port, token and snapshot: the
     daemon rejoins (seconds), get_actor("gpt2") gives a fresh actor under
     the same daemon pid with identical tokens (K1, K2; head 2's init to
     its first token), the KV entry and the job counter kept; (e) no
     daemon, worker or /dev/shm/ray_tpu_torch_* segment left (the
     SIGKILLed processes' own segments listed and removed), and the card's
     memory back within LEFT_LIMIT_MIB of the phase's start. `[nodes]`
     lines.
 21. cluster — the dashboard and cluster tooling (dashboard/,
     autoscaler/, util/state/, job_submission.py, scripts/cli.py): a head
     in this process with isolation="process", no GPU, include_dashboard
     on a free port, serve_clients(port=0) and an autoscaler Monitor over
     a SubprocessNodeProvider whose one node type is {"CPU": 4, "GPU": 1};
     (a) a GPT-2 125M server actor at 0.5 GPU, infeasible on the head,
     makes the monitor launch one node daemon, and comes up under it
     (demand to launch, launch to the daemon's welcome, welcome to the
     first token); a task that imports torch leaves a worker in the
     node's pool; the 8 prompts, each alone from an empty prefix cache,
     token-identical to phase 20's, with phase 20's launches (K1, K2
     counted in the daemon's worker); (b) every dashboard route answers
     200 (its latency printed): two alive nodes, one with GPU 1; the
     server on the daemon's node; /api/llm's live engine, its decode
     tokens what (a) generated; a marker the server's worker printed in
     /api/logs; two history samples; the ray_tpu_* gauges in /metrics;
     (c) a job submitted with JobSubmissionClient, whose entrypoint
     connects with init(address=...) and runs phase 20's train (0.5 GPU,
     on the daemon): SUCCEEDED, its loss line in its log, losses bit for
     bit and launches (K4-K7) equal to phase 20's; meanwhile the CLI
     (`job status`, `logs --address`, `top --url`) as processes, each
     exit 0; (d) the server killed, the idle daemon terminated within the
     idle timeout plus two update intervals, its workers gone, the node
     DEAD in /api/nodes, the card's used memory back within
     LEFT_LIMIT_MIB of the phase's start; (e) no daemon, worker, job
     process or /dev/shm/ray_tpu_torch_* segment left. `[cluster]` lines.
 22. lint    — the port's static analyzer (ray_tpu_torch/tools/lint) as a
     subprocess from the repo root: `python3 -m ray_tpu_torch.tools.lint
     ray_tpu_torch --json` exits 0 with no active finding, parse error,
     stale or untriaged baseline entry, scans every .py file of the
     package outside __pycache__ and _build (counted after the build
     phase filled ops/_build/), in duration_s < 10; `python3 -m
     ray_tpu_torch.scripts.cli lint --list-rules` exits 0 naming every
     rule not ported. Every kernel's counter (K1-K10) set to 0 just before
     and read just after: all 0. One `[lint]` line.
After each teardown (serve, every loadgen cell, loadgen, fabric, moe, each
tune fit(), each rllib and rllib_algos part, each data fit(), store, nodes,
cluster) the card memory must be back within LEFT_LIMIT_MIB (64 MiB) of
its figure before the run; beyond it the script prints what holds the
memory (`_card_holders`) and fails.
Before the last two lines, a `[phases]` line gives each phase's wall
seconds.

`python3 chip_smoke.py --phase tp` runs one other phase instead, on every
card it sees (run it on a host with four cards); with fewer than two cards
it fails and prints no result. tp — tensor parallelism over NCCL
(ray_tpu_torch.parallel, llm.tp_worker): the server phase's GPT-2 125M
(seed 0), engine config and 8 prompts at tensor_parallel_size 1, 2 and 4,
in f32 and in bf16, each an LLMServer whose process is rank 0 and whose
warmup ran every bucket on every rank. Per run: K1's and K2's counters set
to 0 on every rank just before the 8 concurrent requests and read just
after (each one non-zero on every rank), the decode steps' wall p50, the
8 prompts again one at a time from an empty prefix cache, the first
step's logits of each prompt (`prefill_logits`), each rank's allocated
memory; after the teardown every worker gone and every card's memory back
(rank 0's allocated memory within LEFT_LIMIT_MIB of its start; by
nvidia-smi, cards 1.. within LEFT_LIMIT_MIB of the phase's start, and card
0 within LEFT_LIMIT_MIB of its level after the phase's first tp > 1 run:
the engine's process lives on, and what its first runs leave outside
torch's allocator, kernels loaded into its context and NCCL's and the CUDA
libraries' per-process state, no teardown releases). f32: the
one-at-a-time tokens at tp=2 and tp=4 equal tp=1's. bf16: equal up to a
step where tp=1's top-2 logit margin (a full forward of tp=1's model over
its own tokens) is under TP_BF16_TOL, each such step printed with its
margin; the first step's logits within TP_BF16_TOL of tp=1's. The first
tp > 1 run, right after the f32 tp=1 run, is one request at tp=2 through
serve.run(llm.serve.build_app(...)), equal to the bf16 tp=2 server's
tokens. Last, a rank killed inside a step: rank 1 of a bf16 tp=2 engine
stopped, then killed a second into the next step; the step raises
TensorParallelError naming rank 1 within TP_TIMEOUT_S of the kill, and
rank 0's stream drains. `[tp]` lines, one `{"tp": ...}` JSON line, and
the {"ok": true, ...} line with the count of cards seen. The last two lines are the kernels JSON (K1's, K2's, K3's, K6's and K7's
entries also carry their launches on every later path, `launches_by_path`, the
rllib and data resnet paths' zeros among them, and the procs, nodes and
cluster paths counted in the worker processes) and the
{"ok": true, ...} contract.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import json
import os
import re
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

# Run from the repository root: the port's package sits beside this file.
from ray_tpu_torch.profiling.timing import PEAK_FLOPS, bound, time_ms

# Kernel against plain version, per output and by the output's dtype (see
# `compare`): relative L2 error, and every element within `ulps` rounding
# steps of its plain value plus `floor_rms` times the output's RMS.
LIMITS = {
    torch.float32: dict(ulps=4, floor_rms=1e-4, rel_l2=1e-5),
    torch.bfloat16: dict(ulps=2, floor_rms=5e-2, rel_l2=1e-2),
}
H, D, BS, NB = 12, 64, 16, 64  # GPT-2 125M heads/width; the server's cache
# Training shapes: the packed path (S <= 2048) and the long-context branch.
TRAIN_B, TRAIN_S, TRAIN_STEPS = 8, 1024, 5
LONG_B, LONG_S, LONG_STEPS = 1, 4096, 2
PARITY_B, PARITY_S, PARITY_LONG_LAYERS = 2, 1024, 2
# The profiling entry points' default shape (the reference scripts' B24
# S1024 H12 D64 bf16), at which K8-K10 are held against their plain versions.
PROF_B, PROF_S = 24, 1024
LR = 3e-4
GRAD_FLOOR = 10 * 1e-8  # 10 x fused_adamw's eps: see _f32_parity
# Times of the kernels before their tensor-core versions (f32 math on the
# CUDA cores in both types), ms, on an H100 80GB HBM3 at 700 W (PERF.md):
# K2 / K6 from this script's kernel phase run on commit 771fee6, K3 from its
# run on commit 1349e5b; K8 and K10 before wgmma (their mma.sync kernels)
# from its profile phase run on commit f3a8580; K1 before its split and
# suffix kernels (one CUDA-core kernel) and K9 before wgmma (mma.sync) from
# its kernel and profile phases run on commit e03bd87. Keys: kernel, case,
# S, causal, dtype (K1: the pools' dtype).
EARLIER_MS = {
    ("K1 paged_attention", "decode", 1, True, "bf16"): 0.0788,
    ("K1 paged_attention", "decode", 1, True, "f32"): 0.0955,
    ("K1 paged_attention", "decode", 1, True, "int8"): 0.0816,
    ("K1 paged_attention", "verify", 5, True, "bf16"): 0.1036,
    ("K1 paged_attention", "verify", 5, True, "f32"): 0.1181,
    ("K1 paged_attention", "verify", 5, True, "int8"): 0.1109,
    ("K1 paged_attention", "suffix", 256, True, "bf16"): 0.0997,
    ("K1 paged_attention", "suffix", 256, True, "f32"): 0.1001,
    ("K1 paged_attention", "suffix", 256, True, "int8"): 0.1089,
    ("K9 flash_fwd_slim", "64x64", 1024, True, "bf16"): 0.2345,
    ("K9 flash_fwd_slim", "64x128", 1024, True, "bf16"): 0.2972,
    ("K9 flash_fwd_slim", "128x64", 1024, True, "bf16"): 0.2380,
    ("K9 flash_fwd_slim", "128x128", 1024, True, "bf16"): 0.2800,
    ("K8 attn_dissect", "L0", 1024, True, "bf16"): 0.3749,
    ("K8 attn_dissect", "L1", 1024, True, "bf16"): 0.4048,
    ("K8 attn_dissect", "L2", 1024, True, "bf16"): 0.4656,
    ("K8 attn_dissect", "L3", 1024, True, "bf16"): 0.2535,
    ("K8 attn_dissect", "L4", 1024, True, "bf16"): 0.4420,
    ("K8 attn_dissect", "2h", 1024, True, "bf16"): 0.4040,
    ("K10 attn_subtile", "T2", 1024, True, "bf16"): 0.4016,
    ("K10 attn_subtile", "T4", 1024, True, "bf16"): 0.3241,
    ("K10 attn_subtile", "T8", 1024, True, "bf16"): 0.2883,
    ("K3 flash_bwd_fused", "train", 1024, True, "bf16"): 4.112,
    ("K2 flash_fwd", "prefill", 128, True, "bf16"): 0.0486,
    ("K2 flash_fwd", "prefill", 128, True, "f32"): 0.0483,
    ("K2 flash_fwd", "prefill", 200, True, "bf16"): 0.0666,
    ("K2 flash_fwd", "prefill", 200, True, "f32"): 0.0650,
    ("K2 flash_fwd", "prefill", 256, True, "bf16"): 0.0836,
    ("K2 flash_fwd", "prefill", 256, True, "f32"): 0.0828,
    ("K2 flash_fwd", "prefill", 1000, True, "bf16"): 0.4012,
    ("K2 flash_fwd", "prefill", 1000, True, "f32"): 0.3930,
    ("K2 flash_fwd", "prefill", 1024, True, "bf16"): 0.4069,
    ("K2 flash_fwd", "prefill", 1024, True, "f32"): 0.3992,
    ("K2 flash_fwd", "prefill", 1024, False, "bf16"): 0.5630,
    ("K2 flash_fwd", "prefill", 1024, False, "f32"): 0.5670,
    ("K2 flash_fwd", "train", 1024, True, "bf16"): 1.9456,
    ("K2 flash_fwd", "train", 1024, True, "f32"): 1.9217,
    ("K6 flash_fwd_packed", "train", 1024, True, "bf16"): 1.9600,
    ("K6 flash_fwd_packed", "train", 1024, True, "f32"): 1.8940,
}


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def sdpa_bwd_ms(q, k, v, do) -> float:
    """Device time of SDPA's backward on the same inputs ([B, S, H, D],
    viewed as [B, H, S, D]): one torch.autograd.grad call through the graph
    of one SDPA forward, timed as the kernels are (time_ms). It computes
    dQ, dK and dV together. A yardstick only."""
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
    out = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    grad = do.transpose(1, 2)
    return time_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), grad, retain_graph=True))


def compare(got: torch.Tensor, want: torch.Tensor, per_row: bool = False) -> dict:
    """One kernel output against its plain version: the largest absolute
    error, the relative L2 error of the whole output, and how far the worst
    element lies past ULPS rounding steps of its plain value, in units of
    the output's RMS (elements near zero, where sums cancel, need that
    floor; a zeroed or mis-masked element lies a whole value past). With
    `per_row`, each row (the last dim) is also held against its own RMS and
    L2 norm, and the worse of the two readings is kept: K8's levels 1-2 mix
    rows of ~1e31 (masked keys add -1e30 v) with rows of ~1e2 (no masked
    key), which the whole output's scale alone would not see."""
    g, w = got.double(), want.double()  # K8's outputs reach ~1e31: no f32 squares
    diff = (g - w).abs()
    eps = torch.finfo(want.dtype).eps  # one rounding step relative to |w|
    excess = diff - LIMITS[want.dtype]["ulps"] * eps * w.abs()
    rms = w.pow(2).mean().sqrt().clamp_min(1e-30)
    out = dict(
        max_abs_err=diff.max().item(),
        rel_l2=(diff.norm() / w.norm().clamp_min(1e-30)).item(),
        floor_rms=(excess.max() / rms).item(),
        rms=rms.item(),
    )
    if per_row:
        row_rms = w.pow(2).mean(-1, keepdim=True).sqrt().clamp_min(1e-30)
        row_l2 = diff.norm(dim=-1) / w.norm(dim=-1).clamp_min(1e-30)
        out.update(rel_l2=max(out["rel_l2"], row_l2.max().item()),
                   floor_rms=max(out["floor_rms"], (excess / row_rms).max().item()),
                   min_row_rms=row_rms.min().item())
    return out


def dtype_label(dtype) -> str:
    return {torch.bfloat16: "bf16", torch.float32: "f32"}[dtype]


def check_close(rows: list, name: str, got: dict, want: dict, label: str,
                per_row: bool = False, **shape) -> None:
    """Record a kernel-vs-plain row and fail if any output, each held on its
    own, passes its dtype's LIMITS (lse is f32 whatever the inputs)."""
    outs = {k: compare(got[k], want[k], per_row) for k in want}
    rows.append(dict(kernel=name, dtype=label, **shape,
                     max_abs_err=max(o["max_abs_err"] for o in outs.values()),
                     outputs=outs))
    for k, o in outs.items():
        lim = LIMITS[want[k].dtype]
        if not (o["rel_l2"] <= lim["rel_l2"] and o["floor_rms"] <= lim["floor_rms"]):
            fail(f"{name} {shape} {label} {k}: {o} past {lim}")


# ---------------------------------------------------------------- phases


def phase_device() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    name = torch.cuda.get_device_name(0)
    log(f"[device] torch: {name}, {torch.__version__}, CUDA {torch.version.cuda}, "
        f"devices={torch.cuda.device_count()}")
    return {"smi": card, "name": name}


def phase_build() -> None:
    from ray_tpu_torch.ops import _kernels

    t0 = time.perf_counter()
    report = _kernels.build()
    for name, info in report.items():
        ptxas = [ln.strip() for ln in info["log"].splitlines()
                 if "registers" in ln or "spill" in ln or "entry function" in ln
                 or "wgmma" in ln]
        log(f"[build] {name}: {info['seconds']:.1f}s")
        for ln in ptxas:
            log(f"[build]   {ln}")
    log(f"[build] total {time.perf_counter() - t0:.1f}s "
        f"({len(report)} compiled, {len(_kernels.KERNELS) - len(report)} cached)")
    # The tensor-core kernels, by library and name: the bf16 forward (K2,
    # K6), the bf16 dQ and dK/dV kernels (K4, K5, K7), the bf16 one-block
    # backward (K3) and K1's bf16 suffix kernel on mma.sync, K8, K9 and K10
    # on wgmma with TMA loads, throughout ("" names every function). A name with no function, or a
    # function with no HMMA / HGMMA instruction, fails; so does a wgmma
    # library's function with no HGMMA, no UTMALDG, or any HMMA (a mma.sync
    # path left beside the wgmma one).
    for lib, names in (("flash_fwd", ("flash_fwd_mma_kernel",)),
                       ("flash_bwd", ("flash_bwd_dq_mma_kernel",
                                      "flash_bwd_dkv_mma_kernel")),
                       ("flash_bwd_fused", ("flash_bwd_fused_mma_kernel",)),
                       ("paged_attention", ("paged_suffix_mma_kernel",)),
                       ("attn_dissect", ("",)), ("attn_slim", ("",)),
                       ("attn_subtile", ("",))):
        ops = sass_instructions(_kernels, lib)
        log(f"[build] {lib} tensor-core and TMA instructions (cuobjdump): "
            f"{json.dumps(ops)}")
        for name in names:
            found = {fn: n for fn, n in ops.items() if name in fn}
            if not found or not all(n["HMMA"] + n["HGMMA"] for n in found.values()):
                fail(f"a {lib} kernel {name!r} has no HMMA / HGMMA instruction: "
                     f"{found or ops}")
            if lib in WGMMA_LIBRARIES and not all(
                    n["HGMMA"] and n["UTMALDG"] and not n["HMMA"]
                    for n in found.values()):
                fail(f"a {lib} kernel lacks HGMMA or UTMALDG, or has HMMA: {found}")


# The libraries whose kernels run wgmma on TMA-loaded tiles (wgmma_tiles.cuh).
WGMMA_LIBRARIES = ("attn_dissect", "attn_slim", "attn_subtile")
SASS_OPS = ("HMMA", "HGMMA", "UTMALDG")


def sass_instructions(kernels, name: str) -> dict:
    """{function: {op: count}} of the tensor-core instructions (HMMA:
    mma.sync, HGMMA: wgmma) and TMA tile loads (UTMALDG) in each kernel
    function of one built library, from the CUDA toolkit's cuobjdump
    --dump-sass."""
    cuobjdump = str(Path(kernels._nvcc()).parent / "cuobjdump")
    sass = subprocess.run([cuobjdump, "--dump-sass", str(kernels._library_path(name))],
                          capture_output=True, text=True, timeout=120)
    if sass.returncode != 0:
        fail(f"cuobjdump: {sass.stderr.strip()}")
    counts, fn = {}, None
    for line in sass.stdout.splitlines():
        head = re.search(r"Function : (\S+)", line)
        if head:
            fn = head.group(1)
            counts.setdefault(fn, dict.fromkeys(SASS_OPS, 0))
        elif fn is not None:
            for op in SASS_OPS:
                if re.search(rf"\b{op}\b", line):
                    counts[fn][op] += 1
    return counts


def check_bitwise_repeat(rows: list, got: dict, again: dict, what: str) -> None:
    """A second run on the same inputs must give every output bit for bit
    (the kernels sum in a fixed order, with no atomics)."""
    same = {n: torch.equal(again[n], got[n]) for n in got}
    rows[-1]["bitwise_repeat"] = same
    if not all(same.values()):
        fail(f"{what}: a second run differs: {same}")


def tflops(row: dict, flops: float) -> None:
    """Achieved TFLOP/s of a timed row, and the earlier kernel's time of the
    same row (EARLIER_MS)."""
    key = (row["kernel"], row["case"], row["S"], row.get("causal", True), row["dtype"])
    row.update(tflops=flops / (row["ms"] * 1e-3) / 1e12, earlier_ms=EARLIER_MS.get(key))


def _paged_case(gen, b, s, ctx, dtype, kv):
    from ray_tpu_torch.ops.paged_flash import quantize_kv

    n_blocks = 1 + b * NB
    dev = "cuda"
    store = torch.float32 if kv == "int8" else dtype
    q = torch.randn(b, s, H, D, generator=gen, device=dev).to(dtype)
    kc = torch.randn(n_blocks, BS, H, D, generator=gen, device=dev).to(store)
    vc = torch.randn(n_blocks, BS, H, D, generator=gen, device=dev).to(store)
    nk = torch.randn(b, s, H, D, generator=gen, device=dev).to(dtype)
    nv = torch.randn(b, s, H, D, generator=gen, device=dev).to(dtype)
    perm = torch.randperm(n_blocks - 1, generator=gen, device=dev) + 1
    tables = perm.view(b, NB).to(torch.int32).contiguous()
    lens = torch.tensor(ctx, dtype=torch.int32, device=dev)
    # Null-pad each table past its context, as the engine does.
    used = (lens + BS - 1) // BS
    tables = torch.where(
        torch.arange(NB, device=dev)[None, :] < used[:, None], tables, 0
    ).to(torch.int32)
    ks = vs = None
    if kv == "int8":
        kc, ks = quantize_kv(kc)
        vc, vs = quantize_kv(vc)
    return q, kc, vc, tables, lens, nk, nv, ks, vs


# K1's kernels: decode and verify launch the split kernel (and its merge when
# the table spans more than one partition), a suffix one of the other two.
K1_LAUNCHES = ("paged_split_kernel", "paged_merge_kernel",
               "paged_suffix_mma_kernel", "paged_attention_kernel")


def phase_kernels() -> list:
    from ray_tpu_torch.ops.attention import paged_attention
    from ray_tpu_torch.ops.flash_attention import (
        flash_attention_fwd,
        flash_attention_reference,
    )
    from ray_tpu_torch.ops.paged_flash import paged_flash_attention

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    decode_ctx = [0, 1, 15, 16, 17, 64, 100, 255, 256, 300, 511, 512, 640,
                  777, 1000, 1023]
    cases = [
        ("decode", 16, 1, decode_ctx),
        ("suffix", 1, 256, [512]),
        ("verify", 16, 5, [min(c, 1019) for c in decode_ctx]),
    ]
    for label, b, s, ctx in cases:
        for dtype, kv in ((torch.bfloat16, "bf16"), (torch.float32, "f32"),
                          (torch.bfloat16, "int8")):
            q, kc, vc, tables, lens, nk, nv, ks, vs = _paged_case(
                gen, b, s, ctx, dtype, kv
            )
            kern = lambda: paged_flash_attention(
                q, kc, vc, tables, lens, new_k=nk, new_v=nv, k_scale=ks,
                v_scale=vs,
            )
            # The plain version on the same (prescaled) inputs: the CPU
            # branch of the wrapper, run here on the card's tensors.
            sm = 1.0 / D ** 0.5
            qs = (q.float() * sm).to(q.dtype)
            plain = lambda: paged_attention(
                qs, kc, vc, tables, lens, new_k=nk, new_v=nv, sm_scale=1.0,
                k_scale=ks, v_scale=vs,
            )
            got = {"o": kern()}
            check_close(rows, "K1 paged_attention", got, {"o": plain()},
                        kv, case=label, B=b, S=s, ctx_max=max(ctx))
            check_bitwise_repeat(rows, got, {"o": kern()}, f"K1 {label} {kv}")
            ms, plain_ms = time_ms(kern), time_ms(plain, reps=10)
            launches_ms = device_ms_by_kernel(kern, K1_LAUNCHES)
            qb = dtype.itemsize
            kvb = 1 if kv == "int8" else qb
            tokens = sum(ctx)
            nbytes = (
                4 * b * s * H * D * qb          # q, new_k, new_v, out
                + 2 * tokens * H * D * kvb      # cached K and V to ctx
                + (2 * tokens * H * 2 if kv == "int8" else 0)
                + b * NB * 4 + b * 4            # tables, lens
            )
            pairs = sum(s * c for c in ctx) + b * s * (s + 1) // 2
            bms, by = bound(nbytes, 4 * D * H * pairs, dtype)
            rows[-1].update(ms=ms, plain_ms=plain_ms, library_ms=None,
                            bound_ms=bms, bound_us=bms * 1e3, bound_by=by,
                            launches_ms={k: v for k, v in launches_ms.items() if v},
                            earlier_ms=EARLIER_MS.get(
                                ("K1 paged_attention", label, s, True, kv)))
            log(json.dumps(rows[-1]))
    # Prefill lengths (S = 200 and 1000 end inside a 64-row tile), and one
    # non-causal row.
    for s, causal in ((128, True), (200, True), (256, True), (1000, True),
                      (1024, True), (1024, False)):
        for dtype in (torch.bfloat16, torch.float32):
            qkv = torch.randn(1, s, 3 * H * D, generator=gen, device="cuda").to(dtype)
            q, k, v = (t.view(1, s, H, D) for t in qkv.split(H * D, dim=-1))
            kern = lambda: flash_attention_fwd(q, k, v, causal=causal)
            plain = lambda: flash_attention_reference(q, k, v, causal=causal)
            got, want = (dict(zip(("o", "lse"), f())) for f in (kern, plain))
            check_close(rows, "K2 flash_fwd", got, want, dtype_label(dtype),
                        case="prefill", B=1, S=s, causal=causal)
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            library = lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal
            )
            ms, plain_ms = time_ms(kern), time_ms(plain, reps=10)
            lib_ms = time_ms(library)
            nbytes = 4 * s * H * D * dtype.itemsize + H * s * 4
            flops = 4 * D * H * (s * (s + 1) // 2 if causal else s * s)
            bms, by = bound(nbytes, flops, dtype)
            rows[-1].update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                            bound_ms=bms, bound_us=bms * 1e3, bound_by=by)
            tflops(rows[-1], flops)
            log(json.dumps(rows[-1]))
    training_kernel_rows(gen, rows)
    pick = {r["kernel"]: r for r in rows
            if r.get("case") == "train" and r["dtype"] == "bf16"}
    k3, k4, k5, k7 = (pick[n] for n in ("K3 flash_bwd_fused", "K4 flash_bwd_dq",
                                        "K5 flash_bwd_dkv", "K7 flash_bwd_packed"))
    log(f"[kernels] backward at B{TRAIN_B} S{TRAIN_S} H{H} D{D} bf16 causal: "
        f"K3 {k3['ms']:.4f} ms ({k3['tflops']:.0f} TFLOP/s on 10 D per pair; "
        f"its dq_finish_kernel "
        f"{k3['finish_ms']:.4f} ms), "
        f"K7 {k7['ms']:.4f} ms, K4 + K5 {k4['ms']:.4f} + {k5['ms']:.4f} = "
        f"{k4['ms'] + k5['ms']:.4f} ms (and the delta pre-pass), SDPA backward "
        f"{k3['library_ms']:.4f} ms, bound {k3['bound_ms']:.4f} ms")
    return rows


def training_kernel_rows(gen, rows: list) -> None:
    """K6 / K7, and K2 / K3 of the "auto" path, at the packed training
    shape, K4 / K5 there and at the long-context shape, each against its
    plain version (same inputs: a packed projection, its forward's O and
    lse, a random upstream gradient)."""
    fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")

    cases = [("train", TRAIN_B, TRAIN_S, dt) for dt in (torch.bfloat16, torch.float32)]
    cases += [("long", LONG_B, LONG_S, dt) for dt in (torch.bfloat16, torch.float32)]
    for case, b, s, dtype in cases:
        e = H * D
        qkv = torch.randn(b, s, 3 * e, generator=gen, device="cuda").to(dtype)
        do = torch.randn(b, s, e, generator=gen, device="cuda").to(dtype)
        q, k, v = (t.unflatten(-1, (H, D)) for t in qkv.split(e, dim=-1))
        do4 = do.unflatten(-1, (H, D))
        shape = dict(case=case, B=b, S=s)
        label = dtype_label(dtype)
        itm = dtype.itemsize
        bse, rows_f32 = b * s * e * itm, b * H * s * 4
        pairs = b * H * s * (s + 1) // 2  # causal (query, key) pairs
        timed = []
        if case == "train":
            kern = lambda: fa.flash_attention_packed_fwd(qkv, H, causal=True)
            plain = lambda: fa.flash_attention_packed_reference(qkv, H, causal=True)
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            lib = lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True)
            (o, lse), want = kern(), plain()
            check_close(rows, "K6 flash_fwd_packed", {"o": o, "lse": lse},
                        dict(zip(("o", "lse"), want)), label, **shape)
            fwd_lib_ms = time_ms(lib)
            timed.append((kern, plain, fwd_lib_ms,
                          bound(4 * bse + rows_f32, 4 * D * pairs, dtype), 4 * D * pairs))
            kern = lambda: fa.flash_attention_packed_bwd(qkv, o, do, lse, H, causal=True)
            plain = lambda: fa.flash_attention_packed_bwd_reference(
                qkv, o, do, lse, H, causal=True)
            # dqkv held as its three column ranges: dq, dk, dv apart.
            split = lambda t: dict(zip(("dq", "dk", "dv"), t.split(e, dim=-1)))
            got, want = (split(f()) for f in (kern, plain))
            check_close(rows, "K7 flash_bwd_packed", got, want, label, **shape)
            check_bitwise_repeat(rows, got, split(kern()), f"K7 {shape} {label}")
            sdpa_ms = sdpa_bwd_ms(q, k, v, do4)
            timed.append((kern, plain, sdpa_ms,
                          bound(8 * bse + rows_f32, 10 * D * pairs + 2 * b * s * e, dtype),
                          14 * D * pairs))
            # K2, the forward the trainer's "auto" path runs, on the strided
            # q / k / v views of the same projection (batch stride 3E): o
            # and lse apart. Its O and lse feed K3, K4 and K5 below, as the
            # trainer's forward gives them to its backward.
            kern = lambda: fa.flash_attention_fwd(q, k, v, causal=True)
            plain = lambda: fa.flash_attention_reference(q, k, v, causal=True)
            (o4, lse4), want = kern(), plain()
            check_close(rows, "K2 flash_fwd", {"o": o4, "lse": lse4},
                        dict(zip(("o", "lse"), want)), label, **shape)
            timed.append((kern, plain, fwd_lib_ms,
                          bound(4 * bse + rows_f32, 4 * D * pairs, dtype), 4 * D * pairs))
            # K3, the one-block backward the trainer's "auto" path runs, on
            # K2's output: dq, dk, dv apart.
            args3 = (q, k, v, o4, do4, lse4)
            kern = lambda: fa.flash_attention_bwd_fused(*args3, causal=True)
            plain = lambda: fa.flash_attention_bwd_fused_reference(*args3, causal=True)
            got, want = (dict(zip(("dq", "dk", "dv"), f())) for f in (kern, plain))
            check_close(rows, "K3 flash_bwd_fused", got, want, label, **shape)
            # dQ's partials are summed in a fixed order: a second run on
            # the same inputs gives every output bit for bit.
            check_bitwise_repeat(rows, got, dict(zip(("dq", "dk", "dv"), kern())),
                                 f"K3 {shape} {label}")
            timed.append((kern, plain, sdpa_ms,
                          bound(8 * bse + rows_f32, 10 * D * pairs + 2 * b * s * e, dtype),
                          10 * D * pairs))
            k3_split(rows[-1], args3, dtype)
        else:
            o4, lse4 = fa.flash_attention_fwd(q, k, v, causal=True)
        delta = fa.flash_bwd_delta(o4, do4)
        args = (q, k, v, do4, lse4, delta)
        kern = lambda: fa.flash_bwd_dq(*args, causal=True)
        plain = lambda: fa.flash_bwd_dq_reference(*args, causal=True)
        got = {"dq": kern()}
        check_close(rows, "K4 flash_bwd_dq", got, {"dq": plain()}, label, **shape)
        check_bitwise_repeat(rows, got, {"dq": kern()}, f"K4 {shape} {label}")
        lib_ms = sdpa_bwd_ms(q, k, v, do4)  # dQ, dK and dV together
        timed.append((kern, plain, lib_ms,
                      bound(5 * bse + 2 * rows_f32, 6 * D * pairs, dtype), 6 * D * pairs))
        kern = lambda: fa.flash_bwd_dkv(*args, causal=True)
        plain = lambda: fa.flash_bwd_dkv_reference(*args, causal=True)
        got, want = (dict(zip(("dk", "dv"), f())) for f in (kern, plain))
        check_close(rows, "K5 flash_bwd_dkv", got, want, label, **shape)
        check_bitwise_repeat(rows, got, dict(zip(("dk", "dv"), kern())),
                             f"K5 {shape} {label}")
        timed.append((kern, plain, lib_ms,
                      bound(6 * bse + 2 * rows_f32, 8 * D * pairs, dtype), 8 * D * pairs))
        torch.cuda.synchronize()
        for row, (kern, plain, lib_ms, (bms, by), *flops) in zip(rows[-len(timed):], timed):
            row.update(ms=time_ms(kern), plain_ms=time_ms(plain, reps=5),
                       library_ms=lib_ms, bound_ms=bms, bound_us=bms * 1e3,
                       bound_by=by)
            if flops:  # the products' operations per causal pair: K2 / K6 4 D,
                tflops(row, flops[0])  # K3 10 D, K4 6 D, K5 8 D, K7 14 D
            log(json.dumps(row))
        del qkv, do, q, k, v, do4, o4, lse4, delta, args
        torch.cuda.empty_cache()
    k3_edge_rows(gen, rows)
    k3_d128_row(gen, rows)


def device_ms_by_kernel(fn, names, reps: int = 10) -> dict:
    """Device time per call of each kernel whose name contains one of
    `names`, from torch.profiler over `reps` calls of `fn`, the L2 flushed
    before each (as time_ms flushes it)."""
    from torch.profiler import ProfilerActivity, profile

    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    out = dict.fromkeys(names, 0.0)
    for e in prof.key_averages():
        for n in names:
            if n in e.key:
                out[n] += e.self_device_time_total / 1e3 / reps
    return out


def k3_split(row: dict, args3: tuple, dtype) -> None:
    """K3's call on the trainer shape's inputs taken apart, into the K3
    row: its two launches' times (the pass over the pairs and
    dq_finish_kernel, by torch.profiler), the partial-dQ workspace and the
    peak of memory the call allocates above what was allocated before it."""
    fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")
    from ray_tpu_torch.ops import _kernels

    lib = _kernels.library("flash_bwd_fused", fa._FUSED_ARGTYPES)
    b, s, h, d = args3[0].shape
    call = lambda: fa.flash_attention_bwd_fused(*args3, causal=True)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    call()
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - base) / 2**20
    split = device_ms_by_kernel(call, ("flash_bwd_fused_mma_kernel",
                                       "fused_bwd_f32_kernel", "dq_finish_kernel"))
    rows_ws = lib.flash_bwd_fused_workspace_rows(s, 1, _kernels.dtype_code(dtype))
    row.update(pairs_kernel_ms=split["flash_bwd_fused_mma_kernel"]
               + split["fused_bwd_f32_kernel"],
               finish_ms=split["dq_finish_kernel"],
               workspace_mib=b * h * rows_ws * d * 4 / 2**20, call_peak_mib=peak)


def k3_d128_row(gen, rows: list) -> None:
    """K3 at head_dim 128 (B8 S1024 H6, bf16 causal: the trainer's width
    in half the heads), against its plain version and timed, on strided
    q / k / v views and K2's O and lse."""
    fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")
    b, s, h, d, dtype = TRAIN_B, TRAIN_S, 6, 128, torch.bfloat16
    e = h * d
    qkv = torch.randn(b, s, 3 * e, generator=gen, device="cuda").to(dtype)
    q, k, v = (t.unflatten(-1, (h, d)) for t in qkv.split(e, dim=-1))
    do = torch.randn(b, s, h, d, generator=gen, device="cuda").to(dtype)
    o, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    args = (q, k, v, o, do, lse)
    kern = lambda: fa.flash_attention_bwd_fused(*args, causal=True)
    plain = lambda: fa.flash_attention_bwd_fused_reference(*args, causal=True)
    got, want = (dict(zip(("dq", "dk", "dv"), f())) for f in (kern, plain))
    check_close(rows, "K3 flash_bwd_fused", got, want, dtype_label(dtype),
                case="d128", B=b, S=s, H=h, D=d)
    check_bitwise_repeat(rows, got, dict(zip(("dq", "dk", "dv"), kern())),
                         f"K3 D{d} {dtype_label(dtype)}")
    pairs = b * h * s * (s + 1) // 2
    bse = b * s * e * dtype.itemsize
    bms, by = bound(8 * bse + b * h * s * 4, 10 * d * pairs + 2 * b * s * e, dtype)
    rows[-1].update(ms=time_ms(kern), plain_ms=time_ms(plain, reps=5),
                    library_ms=sdpa_bwd_ms(q, k, v, do), bound_ms=bms,
                    bound_us=bms * 1e3, bound_by=by)
    tflops(rows[-1], 10 * d * pairs)
    log(json.dumps(rows[-1]))
    del qkv, q, k, v, do, o, lse, args, got, want
    torch.cuda.empty_cache()


def k3_edge_rows(gen, rows: list) -> None:
    """K3 against its plain version where its tiles end early: B2 S1000
    (1000 is not a multiple of the 64-row key tile) and non-causal at
    S256, bf16; dq, dk, dv apart."""
    fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")
    for b, s, causal in ((2, 1000, True), (2, 256, False)):
        dtype, e = torch.bfloat16, H * D
        qkv = torch.randn(b, s, 3 * e, generator=gen, device="cuda").to(dtype)
        q, k, v = (t.unflatten(-1, (H, D)) for t in qkv.split(e, dim=-1))
        do = torch.randn(b, s, H, D, generator=gen, device="cuda").to(dtype)
        o, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
        args = (q, k, v, o, do, lse)
        got, want = (dict(zip(("dq", "dk", "dv"), f(*args, causal=causal)))
                     for f in (fa.flash_attention_bwd_fused,
                               fa.flash_attention_bwd_fused_reference))
        check_close(rows, "K3 flash_bwd_fused", got, want, dtype_label(dtype),
                    case="tail" if causal else "full", B=b, S=s)
        log(json.dumps(rows[-1]))


def phase_profile(rows: list) -> dict:
    """The three profiling entry points at their default shape, each with
    its kernel's launch counter set to 0 just before and read just after
    (K8 by attn_dissect, K9 by attn_variants, K10 by attn_subtile); then
    every K8 level and the two-head variant, every K9 tile and every K10 T
    held against its plain version under LIMITS."""
    from ray_tpu_torch.ops import attn_profile as ap
    from ray_tpu_torch.profiling import attn_dissect, attn_subtile, attn_variants

    t_phase = time.perf_counter()
    launches, profiled = {}, {}
    for name, module, wrapper in (
            ("K8 attn_dissect", attn_dissect, ap.attn_dissect),
            ("K9 flash_fwd_slim", attn_variants, ap.flash_fwd_slim),
            ("K10 attn_subtile", attn_subtile, ap.attn_subtile)):
        wrapper.launches = 0
        t0 = time.perf_counter()
        profiled[name] = module.main([])
        launches[name] = wrapper.launches
        log(f"[profile] {module.__name__}: {time.perf_counter() - t0:.1f}s, "
            f"{name} launched {launches[name]} times")
        for r in profiled[name]:
            log("[profile] " + json.dumps(r))
        if launches[name] == 0:
            fail(f"{module.__name__} did not launch {name}")
    profile_kernel_rows(rows, profiled)
    log(f"[profile] phase {time.perf_counter() - t_phase:.1f}s")
    return {"launches": launches, "rows": profiled}


def profile_kernel_rows(rows: list, profiled: dict) -> None:
    """K8-K10 against their plain versions on one seeded input at the
    entry points' shape, each variant a row: its time is the entry point's
    (`ms`, bound), the plain version's and the library yardstick's are
    timed here. Library: SDPA causal with scale 1 for K8's full softmax
    (level 4, two heads) and K10, SDPA causal for K9; none for K8's levels
    0-3, which are not attention. K8's levels 1-2 are held row by row as
    well (`compare`'s per_row). Each variant runs twice and must repeat bit
    for bit; its row also carries the share of each output's elements
    bit-identical to the plain version's and the earlier kernel's time
    (EARLIER_MS), and K9's the device time of its kernel alone (`kernel_ms`:
    the row's time includes the wrapper's prescale of q)."""
    from ray_tpu_torch.ops import attn_profile as ap

    gen = torch.Generator(device="cuda").manual_seed(1)
    q, k, v = (torch.randn(PROF_B * H, PROF_S, D, generator=gen, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    # SDPA takes [B, H, S, D] (a 3-D input falls to its unfused math path).
    q4, k4, v4 = (t.unsqueeze(0) for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_unscaled = time_ms(lambda: sdpa(q4, k4, v4, is_causal=True, scale=1.0))
    lib_scaled = time_ms(lambda: sdpa(q4, k4, v4, is_causal=True))
    cases = []  # (name, entry row, case, kernel, plain, library ms, per_row)
    for r in profiled["K8 attn_dissect"][1:]:
        lvl, two = r["level"], r["two_heads"]
        cases.append(("K8 attn_dissect", r, "2h" if two else f"L{lvl}",
                      lambda lvl=lvl, two=two: {"o": ap.attn_dissect(q, k, v, lvl, two)},
                      lambda lvl=lvl, two=two: {
                          "o": ap.attn_dissect_reference(q, k, v, lvl, two)},
                      lib_unscaled if lvl == 4 or two else None,
                      lvl in (1, 2) and not two))
    for r in profiled["K9 flash_fwd_slim"][1:]:
        bm, bn = r["block_q"], r["block_k"]
        cases.append(("K9 flash_fwd_slim", r, f"{bm}x{bn}",
                      lambda bm=bm, bn=bn: dict(zip(("o", "lse"), ap.flash_fwd_slim(
                          q, k, v, block_q=bm, block_k=bn))),
                      lambda bn=bn: dict(zip(("o", "lse"), ap.flash_fwd_slim_reference(
                          q, k, v, block_k=bn))),
                      lib_scaled, False))
    for r in profiled["K10 attn_subtile"][1:]:
        t = r["T"]
        cases.append(("K10 attn_subtile", r, f"T{t}",
                      lambda t=t: dict(zip(("o", "lse"), ap.attn_subtile(q, k, v, t))),
                      lambda t=t: dict(zip(("o", "lse"), ap.attn_subtile_reference(
                          q, k, v, t))),
                      lib_unscaled, False))
    for name, r, case, kern, plain, lib_ms, per_row in cases:
        got, want = kern(), plain()
        check_close(rows, name, got, want, "bf16", per_row=per_row,
                    case=case, B=PROF_B, S=PROF_S)
        check_bitwise_repeat(rows, got, kern(), f"{name} {case}")
        if name == "K9 flash_fwd_slim":  # the kernel apart from q's prescale
            rows[-1]["kernel_ms"] = device_ms_by_kernel(
                kern, ("flash_fwd_slim_kernel",))["flash_fwd_slim_kernel"]
        rows[-1].update(ms=r["ms"], plain_ms=time_ms(plain, reps=3), library_ms=lib_ms,
                        bound_ms=r["bound_ms"], bound_us=r["bound_ms"] * 1e3,
                        bound_by=r["bound_by"], tflops=r["tflops"],
                        current_ms=r["current_ms"], within_limits=True,
                        earlier_ms=EARLIER_MS.get((name, case, PROF_S, True, "bf16")),
                        bit_identical={n: (got[n] == want[n]).double().mean().item()
                                       for n in got})
        log(json.dumps(rows[-1]))
    torch.cuda.empty_cache()


def _train_step(model, opt, state, params, tokens):
    """One training step as the reference's benchmark builds it: forward,
    the shifted-token loss (plus the MoE aux losses of a model with
    experts, as the reference's test_parallel.py folds them in), every
    parameter's gradient, a fused_adamw update (in place). Returns (loss,
    grads, state)."""
    from ray_tpu_torch.models import collect_moe_losses, cross_entropy_loss

    if model.config.num_experts:
        logits, inter = model(tokens, return_aux=True)
        loss = cross_entropy_loss(logits[:, :-1], tokens[:, 1:]) + collect_moe_losses(inter)
    else:
        logits = model(tokens)
        loss = cross_entropy_loss(logits[:, :-1], tokens[:, 1:])
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    _, state = opt.apply(grads, state, params)
    return loss.detach(), grads, state


def _tokens(b, s, seed=0):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randint(0, 50257, (b, s), generator=gen, device="cuda")


def _run_steps(model, tokens, steps) -> tuple:
    """`steps` fused_adamw steps on one batch: (losses, step seconds)."""
    from ray_tpu_torch.ops import fused_adamw

    params = dict(model.named_parameters())
    opt = fused_adamw(LR)
    state = opt.init(params)
    losses, times = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        loss, _, state = _train_step(model, opt, state, params, tokens)
        losses.append(loss.item())  # syncs
        times.append(time.perf_counter() - t0)
    if not all(np.isfinite(losses)):
        fail(f"non-finite training loss: {losses}")
    return losses, times, (opt, state, params)


def _rel_l2(a, b) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30)).item()


def phase_train() -> dict:
    from torch.profiler import ProfilerActivity, profile

    from ray_tpu_torch.models.gpt import GPT, gpt2_125m
    fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")

    counters = {
        "K2 flash_fwd": fa.flash_attention_fwd,
        "K4 flash_bwd_dq": fa.flash_bwd_dq,
        "K5 flash_bwd_dkv": fa.flash_bwd_dkv,
        "K6 flash_fwd_packed": fa.flash_attention_packed_fwd,
        "K7 flash_bwd_packed": fa.flash_attention_packed_bwd,
    }

    def zero():
        for f in counters.values():
            f.launches = 0

    def read():
        return {k: f.launches for k, f in counters.items()}

    cfg = gpt2_125m()  # bf16 compute, f32 params, attention_impl="flash"
    model = GPT(cfg, seed=0)
    if any(p.dtype != torch.float32 for p in model.parameters()):
        fail("GPT parameters are not f32 masters")
    tokens = _tokens(TRAIN_B, TRAIN_S)
    layers = cfg.num_layers

    # The main training path: counters from 0, 5 steps, counters read.
    zero()
    losses, times, (opt, state, params) = _run_steps(model, tokens, TRAIN_STEPS)
    launches = read()
    if not losses[-1] < losses[0]:
        fail(f"training loss did not fall on one batch: {losses}")
    for name in ("K6 flash_fwd_packed", "K7 flash_bwd_packed"):
        if launches[name] != layers * TRAIN_STEPS:
            fail(f"{name} launched {launches[name]} times, not {layers} x {TRAIN_STEPS}")
    if any(p.dtype != torch.float32 for p in model.parameters()):
        fail("a parameter left f32 after fused_adamw")
    step_p50 = statistics.median(times)
    summary = {
        "model": "gpt2_125m bf16 (f32 params)", "B": TRAIN_B, "S": TRAIN_S,
        "steps": TRAIN_STEPS, "losses": losses, "step_s": times,
        "step_p50_s": step_p50, "tokens_per_s": TRAIN_B * TRAIN_S / step_p50,
        "launches": dict(launches),
    }
    log("[train] " + json.dumps(summary))

    # Where the time goes: one more step under torch.profiler (the wall is
    # taken inside the profiled block: starting the profiler is not the
    # step's time).
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _, state = _train_step(model, opt, state, params, tokens)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device_us = {e.key: e.self_device_time_total for e in prof.key_averages()
                 if e.self_device_time_total > 0}
    busy = sum(device_us.values()) / 1e6
    top = sorted(device_us.items(), key=lambda kv: -kv[1])[:8]
    summary.update(profiled_wall_s=wall, device_busy_s=busy, device_busy_share=busy / wall,
                   top_kernels_ms={k[:70]: v / 1e3 for k, v in top})
    log("[train] profiled step: " + json.dumps({
        "wall_s": wall, "device_busy_s": busy, "device_busy_share": busy / wall,
        "top_kernels_ms": summary["top_kernels_ms"],
    }))
    del model, opt, state, params, tokens
    torch.cuda.empty_cache()

    # The long-context branch (S > 2048): K2 forward, K4 / K5 backward.
    long_cfg = gpt2_125m(max_seq_len=LONG_S)
    model = GPT(long_cfg, seed=0)
    tokens = _tokens(LONG_B, LONG_S, seed=1)
    zero()
    losses_l, times_l, _ = _run_steps(model, tokens, LONG_STEPS)
    launches_l = read()
    for name in ("K2 flash_fwd", "K4 flash_bwd_dq", "K5 flash_bwd_dkv"):
        if launches_l[name] != layers * LONG_STEPS:
            fail(f"long context: {name} launched {launches_l[name]} times, "
                 f"not {layers} x {LONG_STEPS}")
    summary["long"] = {
        "B": LONG_B, "S": LONG_S, "steps": LONG_STEPS, "losses": losses_l,
        "step_s": times_l, "tokens_per_s": LONG_B * LONG_S / statistics.median(times_l),
        "launches": dict(launches_l),
    }
    log("[train] long context: " + json.dumps(summary["long"]))
    del model, tokens
    torch.cuda.empty_cache()

    summary["parity"] = [
        _f32_parity(gpt2_125m(dtype=torch.float32), PARITY_B, PARITY_S),
        _f32_parity(gpt2_125m(dtype=torch.float32, max_seq_len=LONG_S,
                              num_layers=PARITY_LONG_LAYERS), 1, LONG_S),
    ]
    summary["launches_main"] = {"K6 flash_fwd_packed": launches["K6 flash_fwd_packed"],
                                "K7 flash_bwd_packed": launches["K7 flash_bwd_packed"],
                                "K4 flash_bwd_dq": launches_l["K4 flash_bwd_dq"],
                                "K5 flash_bwd_dkv": launches_l["K5 flash_bwd_dkv"]}
    return summary


# A routing decision that differs between two f32 runs of the same step
# must be a near-tie: the probabilities of the two choices within this.
ROUTING_TIE = 1e-4


class _RoutingReplay:
    """Around two runs of the same MoE step: records each MoE layer's
    expert choice (`models.moe._top_k`) on the first run and hands the
    same choices to the second, so that both compute one function. Top-k
    is discontinuous: a near-tie that f32 rounding tips one way on one path
    and the other way on the other moves a token to another expert and,
    under capacity, the choice-major positions of every later pair, which
    no tolerance on the rest of the step could absorb. The second run's
    own choices are counted against the recorded ones: how many tokens
    differed, and by how much probability at most."""

    def __init__(self):
        self.moe = importlib.import_module("ray_tpu_torch.models.moe")
        self.inner = self.moe._top_k
        self.recorded, self.at = [], None
        self.decisions = self.flips = 0
        self.max_margin = 0.0

    def __enter__(self):
        self.moe._top_k = self
        return self

    def __exit__(self, *exc):
        self.moe._top_k = self.inner

    def replay(self) -> None:
        self.at = 0

    def __call__(self, probs, k):
        own = self.inner(probs, k)
        if self.at is None:
            self.recorded.append(own)
            return own
        want = self.recorded[self.at]
        self.at += 1
        self.decisions += own.shape[0]
        self.flips += int((own != want).any(-1).sum())
        margin = (probs.gather(1, own) - probs.gather(1, want)).max().item()
        self.max_margin = max(self.max_margin, margin)
        return want

    def summary(self) -> dict:
        return {"replayed_calls": self.at, "tokens_routed": self.decisions,
                "tokens_whose_own_choice_differed": self.flips,
                "max_margin": self.max_margin, "tie_bound": ROUTING_TIE}


def _f32_parity(cfg, b, s, tag="train") -> dict:
    """One f32 step through the kernels and through attention_impl=
    'reference' on the same weights and batch: the loss within 1e-5
    relative, every gradient within 1e-4 relative L2, and after a
    fused_adamw step every parameter within 1e-4 relative L2. Adam's first
    update is lr * g / (|g| + eps), a step of ±lr whose sign is the
    gradient's. Where |g| is below the two sides' gradient difference,
    rounding alone can flip that sign, so elements whose plain gradient is
    below GRAD_FLOOR are left out of the parameter check: among them the key
    third of each qkv bias, whose exact gradient is zero (q·b_k cancels in
    the softmax). The floor lies above the largest gradient difference
    measured on the H100 (8.0e-8); how many elements it leaves out, the
    leaf it takes most from, and the largest gradient difference of this
    run are printed. For an MoE model the kernel path takes the plain
    path's routing (`_RoutingReplay`); where its own would have differed,
    the two choices must be a near-tie (ROUTING_TIE)."""
    import dataclasses

    from ray_tpu_torch.models.gpt import GPT
    from ray_tpu_torch.ops import fused_adamw

    kern = GPT(cfg, seed=0)
    plain = GPT(dataclasses.replace(cfg, attention_impl="reference"), seed=0)
    plain.load_state_dict(kern.state_dict())
    tokens = _tokens(b, s, seed=2)
    out = {}
    replay = _RoutingReplay() if cfg.num_experts else None
    with replay or contextlib.nullcontext():
        for label, model in (("plain", plain), ("kernels", kern)):
            if replay is not None and label == "kernels":
                replay.replay()
            params = dict(model.named_parameters())
            opt = fused_adamw(LR)
            loss, grads, _ = _train_step(model, opt, opt.init(params), params, tokens)
            out[label] = (loss.item(), grads, params)
            del grads
    (lk, gk, pk), (lp, gp, pp) = out["kernels"], out["plain"]
    loss_rel = abs(lk - lp) / abs(lp)
    grad_rel = {n: _rel_l2(gk[n], gp[n]) for n in gk}
    grad_diff = max((gk[n] - gp[n]).abs().max().item() for n in gk)
    param_rel, left_out, dropped_g = {}, {}, 0.0
    for n in pk:
        keep = gp[n].abs() >= GRAD_FLOOR
        param_rel[n] = _rel_l2(pk[n].detach()[keep], pp[n].detach()[keep])
        left_out[n] = int((~keep).sum())
        if left_out[n]:
            dropped_g = max(dropped_g, gp[n][~keep].abs().max().item())
    most_out = max(left_out, key=lambda n: left_out[n] / pk[n].numel())
    worst_g = max(grad_rel, key=grad_rel.get)
    worst_p = max(param_rel, key=param_rel.get)
    res = {"layers": cfg.num_layers, "B": b, "S": s, "loss_kernels": lk,
           "loss_plain": lp, "loss_rel": loss_rel, "grad_rel_max": grad_rel[worst_g],
           "grad_worst": worst_g, "grad_abs_diff_max": grad_diff,
           "param_rel_max": param_rel[worst_p], "param_worst": worst_p,
           "param_elements": sum(p.numel() for p in pk.values()),
           "left_out": sum(left_out.values()), "left_out_grad_max": dropped_g,
           "left_out_most": most_out,
           "left_out_most_share": left_out[most_out] / pk[most_out].numel()}
    if replay is not None:
        res["routing"] = replay.summary()
    log(f"[{tag}] f32 parity: " + json.dumps(res))
    if replay is not None and replay.at != len(replay.recorded):
        fail(f"[{tag}] the kernel path routed {replay.at} times, the plain path "
             f"{len(replay.recorded)}")
    if replay is not None and not replay.max_margin <= ROUTING_TIE:
        fail(f"[{tag}] the kernel path's own routing left the plain path's by "
             f"{replay.max_margin} in probability, beyond a near-tie ({ROUTING_TIE})")
    if not loss_rel <= 1e-5:
        fail(f"f32 loss: kernels {lk} vs plain {lp}")
    if not grad_rel[worst_g] <= 1e-4:
        fail(f"f32 gradient of {worst_g}: relative L2 {grad_rel[worst_g]}")
    if not param_rel[worst_p] <= 1e-4:
        fail(f"f32 parameter {worst_p} after the step: relative L2 {param_rel[worst_p]}")
    del kern, plain, out
    torch.cuda.empty_cache()
    return res


def _fingerprint(parts: dict) -> dict:
    """Per leaf of each part ({part: {name: tensor}}), computed where the
    tensor lies: its dtype, its float64 sum and a position-weighted sum of
    its bytes. A checkpoint that drops, casts, reorders or stales a value
    changes it."""
    out = {}
    for part, leaves in parts.items():
        for name, t in leaves.items():
            t = t.detach().contiguous()
            raw = t.view(-1).view(torch.uint8).to(torch.int64)
            weight = torch.arange(raw.numel(), device=raw.device) % 65521 + 1
            out[f"{part}/{name}"] = [str(t.dtype), t.double().sum().item(),
                                     (raw * weight).sum().item()]
    return out


def _trainer_loop(config):
    """The train loop of the trainer phase, run by TorchTrainer in its worker
    actor: GPT-2 125M (bf16 compute, f32 params, attention_impl="auto") on
    the worker's device, `config["steps"]` fused_adamw steps on one seeded
    batch through prepare_params / prepare_batch / prepare_step. Resumed
    from a checkpoint, it restores the parameters and both moments, checks
    them bit for bit against the checkpoint, and reports their fingerprint
    on the device (`_fingerprint`). Each step reports its loss and time; the
    step `config["profile_step"]` runs under torch.profiler; the last step
    reports the fingerprint of the live parameters and moments, and a
    checkpoint of them (on the host)."""
    from torch.profiler import ProfilerActivity, profile

    from ray_tpu_torch import train
    from ray_tpu_torch.air import Checkpoint
    from ray_tpu_torch.models.gpt import GPT, gpt2_125m
    from ray_tpu_torch.ops import FusedAdamWState, fused_adamw

    t_setup = time.perf_counter()
    device = train.get_device()
    model = GPT(gpt2_125m(attention_impl="auto"), device=device, seed=0)
    params = dict(model.named_parameters())
    opt = fused_adamw(LR)
    state = opt.init(params)
    restored = restored_fp = None
    saved = train.get_checkpoint()
    if saved is not None:
        saved = saved.to_dict()
        with torch.no_grad():
            for name, value in train.prepare_params(saved["params"]).items():
                params[name].copy_(value)
        state = FusedAdamWState(count=saved["count"].clone(),
                                mu=train.prepare_params(saved["mu"]),
                                nu=train.prepare_params(saved["nu"]))
        restored = all(
            torch.equal(live[k].detach().cpu(), saved[part][k])
            for part, live in (("params", params), ("mu", state.mu), ("nu", state.nu))
            for k in params
        )
        restored_fp = _fingerprint({"params": params, "mu": state.mu, "nu": state.nu})
    start = int(state.count)
    gen = torch.Generator().manual_seed(0)
    tokens = train.prepare_batch(
        torch.randint(0, 50257, (TRAIN_B, TRAIN_S), generator=gen))
    opt_state = {"state": state}
    torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_setup

    def step():
        loss, _, opt_state["state"] = _train_step(model, opt, opt_state["state"],
                                                  params, tokens)
        return loss

    step = train.prepare_step(step)
    last = start + config["steps"] - 1
    for i in range(start, last + 1):
        metrics = {"step": i, "restored_bit_for_bit": restored,
                   "restored_fingerprint": restored_fp if i == start else None,
                   "setup_s": setup_s}
        if i == config.get("profile_step"):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                torch.cuda.synchronize(device)
                t0 = time.perf_counter()
                loss = step()
                torch.cuda.synchronize(device)
                wall = time.perf_counter() - t0
            device_us = {e.key: e.self_device_time_total for e in prof.key_averages()
                         if e.self_device_time_total > 0}
            top = sorted(device_us.items(), key=lambda kv: -kv[1])[:6]
            metrics["profile"] = {
                "wall_s": wall, "device_busy_s": sum(device_us.values()) / 1e6,
                "top_kernels_ms": {k[:70]: v / 1e3 for k, v in top}}
        else:
            t0 = time.perf_counter()
            loss = step()  # bounded by torch.cuda.synchronize (instrumented)
            wall = time.perf_counter() - t0
        metrics.update(loss=loss.item(), step_s=wall)
        ckpt = None
        if i == last:
            t_ckpt = time.perf_counter()
            state = opt_state["state"]
            metrics["fingerprint"] = _fingerprint(
                {"params": params, "mu": state.mu, "nu": state.nu})
            ckpt = Checkpoint.from_dict({
                "params": {k: p.detach().cpu() for k, p in params.items()},
                "mu": {k: m.cpu() for k, m in state.mu.items()},
                "nu": {k: m.cpu() for k, m in state.nu.items()},
                "count": state.count.clone(),
            })
            metrics["checkpoint_s"] = time.perf_counter() - t_ckpt
        train.report(metrics, checkpoint=ckpt)


def phase_trainer() -> dict:
    """GPT-2 125M through ray_tpu_torch.train.TorchTrainer: init the
    in-process runtime, fit() 5 steps on a worker actor on cuda:0 with the
    launch counters zeroed just before and read just after (K2 and K3 12 per
    step, K4-K7 none) and the peak of allocated device memory over them, then a second fit() resuming from the first's
    checkpoint for one step (its own counts), then f32 parity of one
    attention_impl="auto" step against "reference"."""
    import ray_tpu_torch
    from ray_tpu_torch.models.gpt import gpt2_125m
    from ray_tpu_torch.train import ScalingConfig, TorchTrainer
    fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")

    counters = {
        "K2 flash_fwd": fa.flash_attention_fwd,
        "K3 flash_bwd_fused": fa.flash_attention_bwd_fused,
        "K4 flash_bwd_dq": fa.flash_bwd_dq,
        "K5 flash_bwd_dkv": fa.flash_bwd_dkv,
        "K6 flash_fwd_packed": fa.flash_attention_packed_fwd,
        "K7 flash_bwd_packed": fa.flash_attention_packed_bwd,
    }
    layers = gpt2_125m().num_layers

    def fit(steps, checkpoint=None, profile_step=None):
        trainer = TorchTrainer(
            _trainer_loop,
            train_loop_config={"steps": steps, "profile_step": profile_step},
            scaling_config=ScalingConfig(num_workers=1),
            resume_from_checkpoint=checkpoint,
        )
        for f in counters.values():
            f.launches = 0
        t0 = time.perf_counter()
        result = trainer.fit()
        wall = time.perf_counter() - t0
        launches = {k: f.launches for k, f in counters.items()}
        if result.error is not None:
            fail(f"TorchTrainer.fit() failed: {result.error!r}")
        history = result.metrics_history
        want = {k: (layers * steps if k in ("K2 flash_fwd", "K3 flash_bwd_fused") else 0)
                for k in counters}
        if launches != want:
            fail(f"trainer launches {launches}, not {want}")
        losses = [m["loss"] for m in history]
        if len(losses) != steps or not all(np.isfinite(losses)):
            fail(f"trainer losses {losses}")
        return result, wall, launches

    ray_tpu_torch.init()
    try:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        result, wall, launches = fit(TRAIN_STEPS, profile_step=TRAIN_STEPS - 1)
        peak_mib = torch.cuda.max_memory_allocated() / 2**20
        history = result.metrics_history
        losses = [m["loss"] for m in history]
        if not losses[-1] < losses[0]:
            fail(f"trainer loss did not fall on one batch: {losses}")
        times = [m["step_s"] for m in history]
        step_p50 = statistics.median(times[:-1])  # the last step is profiled
        prof = history[-1]["profile"]
        summary = {
            "model": "gpt2_125m bf16 (f32 params), attention_impl=auto",
            "B": TRAIN_B, "S": TRAIN_S, "steps": TRAIN_STEPS, "losses": losses,
            "step_s": times, "step_p50_s": step_p50,
            "tokens_per_s": TRAIN_B * TRAIN_S / step_p50,
            "fit_wall_s": wall, "fit_overhead_s": wall - sum(times),
            "loop_setup_s": history[0]["setup_s"],
            "checkpoint_to_host_s": history[-1]["checkpoint_s"],
            "profiled_step": {**prof, "device_busy_share": prof["device_busy_s"] / prof["wall_s"]},
            "launches": launches, "peak_alloc_mib": peak_mib,
        }
        log("[trainer] " + json.dumps(summary))
        resumed, wall_r, launches_r = fit(1, checkpoint=result.checkpoint)
        last = resumed.metrics_history[-1]
        if last["step"] != TRAIN_STEPS or last["restored_bit_for_bit"] is not True:
            fail(f"resumed fit: step {last['step']}, restored "
                 f"{last['restored_bit_for_bit']}")
        # The live state's fingerprint before the checkpoint left the card,
        # against the restored state's on the card, leaf by leaf.
        saved_fp = history[-1]["fingerprint"]
        restored_fp = last["restored_fingerprint"]
        if not saved_fp or restored_fp != saved_fp:
            bad = sorted(k for k in saved_fp
                         if (restored_fp or {}).get(k) != saved_fp[k])
            fail(f"resumed fit: {len(bad)} of {len(saved_fp)} restored leaves "
                 f"differ from the saved state, first {bad[:3]}")
        summary["resumed"] = {"step": last["step"], "loss": last["loss"],
                              "restored_bit_for_bit": True,
                              "fingerprint_leaves": len(saved_fp), "fit_wall_s": wall_r,
                              "loop_setup_s": last["setup_s"],
                              "launches": launches_r}
        log("[trainer] resumed: " + json.dumps(summary["resumed"]))
    finally:
        ray_tpu_torch.shutdown()
    torch.cuda.empty_cache()
    summary["parity"] = _f32_parity(
        gpt2_125m(dtype=torch.float32, attention_impl="auto"), PARITY_B, PARITY_S)
    return summary


def _prompts(rng) -> list:
    """8 prompts: one long enough (~600) for chunked prefill, two sharing
    a 64-token prefix, one repeated block-aligned prompt (prefix cache hit
    on the whole prompt, so its last block is copied on write), and mixed
    lengths."""
    vocab = 50257
    shared = list(rng.randint(0, vocab, 64))
    repeated = list(rng.randint(0, vocab, 96))
    return [
        list(rng.randint(0, vocab, 600)),
        shared + list(rng.randint(0, vocab, 40)),
        shared + list(rng.randint(0, vocab, 77)),
        repeated,
        repeated,
        list(rng.randint(0, vocab, 9)),
        list(rng.randint(0, vocab, 150)),
        list(rng.randint(0, vocab, 333)),
    ]


ENGINE_BASE = dict(block_size=16, num_blocks=1024, max_decode_slots=16,
                   max_blocks_per_seq=64)


def _engine_config():
    from ray_tpu_torch.llm import EngineConfig

    return EngineConfig(**ENGINE_BASE)


def _concurrent(server, prompts, n_new) -> tuple:
    """Every prompt from its own thread through generate_stream: (token
    lists, client-side TTFTs, wall seconds until the card is idle)."""
    results = [None] * len(prompts)
    ttft = [None] * len(prompts)

    def client(i):
        t_sub = time.perf_counter()
        toks = []
        for tok in server.generate_stream(prompts[i], max_new_tokens=n_new):
            if not toks:
                ttft[i] = time.perf_counter() - t_sub
            toks.append(tok)
        results[i] = toks

    threads = [threading.Thread(target=client, args=(i,)) for i in range(len(prompts))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    torch.cuda.synchronize()
    return results, ttft, time.perf_counter() - t0


def _sequential(server, prompts, n_new) -> list:
    return [server.generate(p, max_new_tokens=n_new)["token_ids"] for p in prompts]


def _free(*servers) -> None:
    for s in servers:
        s.shutdown()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def phase_server() -> dict:
    from ray_tpu_torch.llm import LLMServer
    from ray_tpu_torch.models.gpt import gpt2_125m
    from ray_tpu_torch.ops.flash_attention import flash_attention_fwd
    from ray_tpu_torch.ops.paged_flash import paged_flash_attention

    n_new = 32
    prompts = _prompts(np.random.RandomState(0))
    t0 = time.perf_counter()
    server = LLMServer(gpt2_125m(), _engine_config(), seed=0)
    log(f"[server] bf16 GPT-2 125M up in {time.perf_counter() - t0:.1f}s "
        f"(init + warmup), kv pools {server.metrics()['kv_pool_bytes'] / 1e6:.0f} MB x2")

    # The main path: counters from 0, 8 concurrent requests, counters read.
    paged_flash_attention.launches = 0
    flash_attention_fwd.launches = 0
    results, ttft, wall = _concurrent(server, prompts, n_new)
    launches = {
        "K1 paged_attention": paged_flash_attention.launches,
        "K2 flash_fwd": flash_attention_fwd.launches,
    }
    m = server.metrics()
    steps = [r["duration_s"] for r in server.flight_record()["steps"]]
    if any(r is None or len(r) != n_new for r in results):
        fail(f"not every request finished with {n_new} tokens: "
             f"{[None if r is None else len(r) for r in results]}")
    if m["prefix_cache_hit_tokens"] <= 0:
        fail("prefix cache never hit")
    for name, n in launches.items():
        if n <= 0:
            fail(f"{name} was not launched on the main path")
    summary = {
        "requests": len(prompts),
        "tokens": n_new * len(prompts),
        "wall_s": wall,
        "tokens_per_s": n_new * len(prompts) / wall,
        "ttft_p50_s": statistics.median(ttft),
        "step_p50_s": statistics.median(steps),
        "steps": m["steps"],
        "prefix_cache_hit_tokens": m["prefix_cache_hit_tokens"],
        "cow_blocks": m["cow_blocks"],
        "chunked_prefill_requests": m["chunked_prefill_requests"],
        "launches": launches,
        "launches_per_request": {k: v / len(prompts) for k, v in launches.items()},
    }
    log("[server] " + json.dumps(summary))
    summary["bf16_tokens"] = results

    # Where the time goes: the same traffic again (prefix cache reset, so
    # the same programs run) under torch.profiler: the card's busy share of
    # the wall time, and the kernels that fill it.
    from torch.profiler import ProfilerActivity, profile

    server.reset_prefix_cache()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, _, wall_p = _concurrent(server, prompts, n_new)
    device_us = {}
    for e in prof.key_averages():
        if e.self_device_time_total > 0:
            device_us[e.key] = e.self_device_time_total
    busy_s = sum(device_us.values()) / 1e6
    top = sorted(device_us.items(), key=lambda kv: -kv[1])[:6]
    summary["profiled_wall_s"] = wall_p
    summary["device_busy_share"] = busy_s / wall_p
    summary["top_kernels_ms"] = {k[:60]: v / 1e3 for k, v in top}
    # K1's kernels (K1_LAUNCHES) apart: their device time in the run.
    summary["k1_device_ms"] = {
        n: sum(v for k, v in device_us.items() if n in k) / 1e3
        for n in K1_LAUNCHES}
    log("[server] profiled: " + json.dumps({
        "wall_s": wall_p, "device_busy_s": busy_s,
        "device_busy_share": busy_s / wall_p,
        "top_kernels_ms": summary["top_kernels_ms"],
        "k1_device_ms": summary["k1_device_ms"],
    }))

    # bf16: agreement with the plain path (reported, not asserted: the
    # kernel prescales q in bf16, the reference scales f32 logits).
    server.reset_prefix_cache()
    got = _sequential(server, prompts, n_new)
    # Each prompt alone from an empty prefix cache too: the tokens the procs
    # phase's actors must give (which prompt shares a cached prefix with
    # which depends on how a pool spreads them).
    cold = []
    for p in prompts:
        server.reset_prefix_cache()
        cold.append(server.generate(p, max_new_tokens=n_new)["token_ids"])
    summary["bf16_sequential_tokens"], summary["bf16_cold_tokens"] = got, cold
    log(f"[server] bf16 one at a time: a cold prefix cache gives the warm one's "
        f"tokens: {cold == got}")
    weights = server.engine.runner.model.state_dict()
    plain = LLMServer(gpt2_125m(attention_impl="reference"), _replace_attn(),
                      params=weights)
    want = _sequential(plain, prompts, n_new)
    _free(server, plain)
    agree = np.mean([a == b for x, y in zip(got, want) for a, b in zip(x, y)])
    log(f"[server] bf16 kernel vs plain-path token agreement: {agree:.4f}")
    summary["bf16_agreement"] = float(agree)

    summary["f32_batched_live_slots"] = _f32_token_identity("server", prompts, n_new)
    return summary


def _f32_token_identity(tag: str, prompts, n_new, **overrides) -> int:
    """f32: token-identical to the plain path on the same weights, first
    through the servers one request at a time, then with all the requests
    live together in one deterministic batch (the engine's own generate,
    once the servers' loops have stopped): per-slot tables, idle lanes'
    null-block scatters, chunked prefill beside decode, CoW under load.
    `overrides` change gpt2_125m's config (both sides). Returns the most
    decode slots live at once in the batched run."""
    from ray_tpu_torch.llm import LLMServer
    from ray_tpu_torch.models.gpt import gpt2_125m

    f32 = LLMServer(gpt2_125m(dtype=torch.float32, **overrides), _engine_config(), seed=0)
    weights = f32.engine.runner.model.state_dict()
    f32_plain = LLMServer(gpt2_125m(dtype=torch.float32, attention_impl="reference",
                                    **overrides), _replace_attn(), params=weights)
    runs = {"one at a time": (_sequential(f32, prompts, n_new),
                              _sequential(f32_plain, prompts, n_new))}
    for s in (f32, f32_plain):
        s.shutdown()
        s.engine.allocator.reset_prefix_cache()
    runs["batched"] = tuple(s.engine.generate(prompts, max_new_tokens=n_new)
                            for s in (f32, f32_plain))
    live = max(r["batch_size"]
               for r in f32.engine.flight_recorder.snapshot()["steps"])
    _free(f32, f32_plain)
    for label, (got, want) in runs.items():
        if any(len(r) != n_new for r in got) or got != want:
            bad = [i for i, (x, y) in enumerate(zip(got, want)) if x != y]
            fail(f"[{tag}] f32 kernel path ({label}) differs from the plain path on "
                 f"requests {bad}")
    if live < len(prompts):
        fail(f"[{tag}] the batched f32 run decoded at most {live} slots at once")
    log(f"[{tag}] f32 kernel path token-identical to the plain path "
        f"({len(prompts)} requests x {n_new} tokens, one at a time and "
        f"batched with up to {live} decode slots live)")
    return live


def _spec_prompt_sets(rng) -> dict:
    """The reference microbenchmark's two speculation sets
    (benchmarks/microbenchmark.py): "repetitive", 8 prompts each a 6-token
    phrase repeated to 32 tokens, and "random", 8 x 32 tokens."""
    vocab = 50257
    repetitive = [(list(rng.randint(0, vocab, 6)) * 6)[:32] for _ in range(8)]
    return {"repetitive": repetitive,
            "random": [list(rng.randint(0, vocab, 32)) for _ in range(8)]}


def _k1_zero() -> None:
    from ray_tpu_torch.ops.flash_attention import flash_attention_fwd
    from ray_tpu_torch.ops.paged_flash import paged_flash_attention

    paged_flash_attention.launches = 0
    paged_flash_attention.routes.update(dict.fromkeys(paged_flash_attention.routes, 0))
    flash_attention_fwd.launches = 0


def _k1_read() -> dict:
    from ray_tpu_torch.ops.flash_attention import flash_attention_fwd
    from ray_tpu_torch.ops.paged_flash import paged_flash_attention

    return {"K1 paged_attention": paged_flash_attention.launches,
            "K1 routes": dict(paged_flash_attention.routes),
            "K2 flash_fwd": flash_attention_fwd.launches}


def _instrument_runner(server) -> dict:
    """Wrap the engine's runner (instance attributes, the engine calls
    through them): at each chained decode_async, whether the step it chains
    from is still running on the card; after each fresh or chained
    dispatch, whether that step is (its enqueue did not wait for it); and
    K1's launches inside verify by route and fed width."""
    from ray_tpu_torch.llm.model_runner import DeviceTokens
    from ray_tpu_torch.ops.paged_flash import paged_flash_attention

    runner = server.engine.runner
    seen = {"chained_pending": [], "own_pending": [], "enqueue_s": [],
            "verify_routes": {}}
    decode_async, verify = runner.decode_async, runner.verify

    def wrapped_decode_async(tokens, *args):
        if isinstance(tokens, DeviceTokens):
            seen["chained_pending"].append(tokens.pending())
        t0 = time.perf_counter()
        out = decode_async(tokens, *args)
        seen["enqueue_s"].append(time.perf_counter() - t0)
        seen["own_pending"].append(out.pending())
        return out

    def wrapped_verify(tokens, *args):
        before = dict(paged_flash_attention.routes)
        out = verify(tokens, *args)
        per = seen["verify_routes"].setdefault(tokens.shape[1], {})
        for route, n in paged_flash_attention.routes.items():
            per[route] = per.get(route, 0) + n - before[route]
        return out

    runner.decode_async, runner.verify = wrapped_decode_async, wrapped_verify
    return seen


def _share(flags) -> float:
    return sum(flags) / len(flags) if flags else 0.0


def _mode_run(server, prompts, n_new, seen=None) -> tuple:
    """One run of `prompts` through the server (each from its own thread),
    the K1 / K2 counters zeroed just before and read just after → (the
    run's figures, its tokens): tokens/s, TTFT p50, step p50 and host-gap
    p50 from the run's flight records; the chained share; the speculation
    counts (summed over the batch at each verify step)."""
    server.reset_prefix_cache()
    first = server.metrics()["steps"]
    if seen is not None:
        for v in seen.values():
            v.clear()
    _k1_zero()
    results, ttft, wall = _concurrent(server, prompts, n_new)
    launches = _k1_read()
    if any(r is None or len(r) != n_new for r in results):
        fail(f"not every request finished with {n_new} tokens: "
             f"{[None if r is None else len(r) for r in results]}")
    steps = [r for r in server.flight_record()["steps"] if r["step"] >= first]
    gaps = [r["host_gap_s"] for r in steps if r["host_gap_s"] is not None]
    dispatching = [r for r in steps if "decode" in r["phase"] or "verify" in r["phase"]]
    verify = [r["speculation"] for r in steps if "speculation" in r]
    proposed = sum(v["proposed"] for v in verify)
    accepted = sum(v["accepted"] for v in verify)
    out = {
        "tokens_per_s": n_new * len(prompts) / wall,
        "ttft_p50_s": statistics.median(ttft),
        "step_p50_s": statistics.median(r["duration_s"] for r in steps),
        "host_gap_p50_s": statistics.median(gaps) if gaps else None,
        "steps": len(steps),
        "chained_share": _share([bool(r.get("chained")) for r in dispatching]),
        "verify_steps": len(verify),
        "accepted_per_verify_step": accepted / len(verify) if verify else None,
        "emitted_per_verify_step": (
            sum(v["emitted"] for v in verify) / len(verify) if verify else None),
        "acceptance_rate": accepted / proposed if proposed else None,
        "launches": launches,
    }
    if seen is not None:
        out["chained_dispatches"] = len(seen["chained_pending"])
        out["chained_pending_share"] = _share(seen["chained_pending"])
        out["dispatch_pending_share"] = _share(seen["own_pending"])
        out["decode_async_enqueue_p50_s"] = (
            statistics.median(seen["enqueue_s"]) if seen["enqueue_s"] else None)
        out["verify_routes"] = {w: dict(r) for w, r in seen["verify_routes"].items()}
    return out, results


def _agreement(got, want) -> float:
    """Share of generated tokens equal at the same position (bf16 runs of
    another batch composition or fed width may flip near-ties)."""
    return float(np.mean([a == b for x, y in zip(got, want) for a, b in zip(x, y)]))


def _serving_server(ecfg, params=None, draft_params=None):
    from ray_tpu_torch.llm import LLMServer
    from ray_tpu_torch.models.gpt import gpt2_125m

    server = LLMServer(gpt2_125m(), ecfg, params=params, seed=0,
                       draft_params=draft_params)
    return server, _instrument_runner(server)


def _top2_margin(model, prompt, toks, j) -> float:
    """The top-2 logit margin of the model (f32, plain attention) at the
    position that emits generated token j."""
    ids = torch.tensor([list(prompt) + list(toks[:j])],
                       device=next(model.parameters()).device)
    with torch.no_grad():
        top = torch.topk(model(ids)[0, -1].float(), 2).values
    return float(top[0] - top[1])


def _decode_async_enqueue_check(runner) -> dict:
    """decode_async enqueues without a stream synchronise: with the card
    parked on a spin kernel, a fresh and a chained dispatch return while
    the card is still busy (their steps pending), under torch's sync debug
    mode "error" (which raises on any synchronising call). Both then match
    the synchronous decode on the same inputs (every slot on the null
    block, so both orders leave the pools alike)."""
    ecfg = runner.engine_config
    slots, nb = ecfg.max_decode_slots, ecfg.max_blocks_per_seq
    tokens = np.arange(1, slots + 1, dtype=np.int32) * 997
    zeros = np.zeros((slots,), np.int32)
    tables = np.zeros((slots, nb), np.int32)
    want = runner.decode(tokens, zeros, tables, zeros)
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)  # ~0.1 s of spinning on the card
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        first = runner.decode_async(tokens, zeros, tables, zeros)
        chained = runner.decode_async(first, zeros, tables, zeros)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    pending = (first.pending(), chained.pending())
    got, got2 = first.fetch(), chained.fetch()
    want2 = runner.decode(got, zeros, tables, zeros)
    if not all(pending):
        fail(f"decode_async waited for the card: pending after enqueue {pending}")
    if not (np.array_equal(got, want) and np.array_equal(got2, want2)):
        fail("decode_async (fresh or chained) differs from decode")
    return {"enqueue_ms": enqueue_ms, "pending_after_enqueue": list(pending)}


def phase_serving_modes() -> dict:
    """Async decode and speculation on GPT-2 125M at full width: (a) async
    off / on / on / off on the server phase's traffic; (b) ngram k = 4 and
    a 2-layer draft at k = 8 on the repetitive and random sets; (c) async
    with ngram; (d) f32 token identity of async, ngram, draft (the target's
    own weights) and async + ngram against the sync kernel path and the
    plain path, on one deterministic batch."""
    import dataclasses

    from ray_tpu_torch.llm import LLMEngine
    from ray_tpu_torch.models.gpt import gpt2_125m

    t_phase = time.perf_counter()
    n_new = 32
    summary = {}
    prompts = _prompts(np.random.RandomState(0))
    sets = _spec_prompt_sets(np.random.RandomState(1))
    base = _engine_config()

    # (a) async off / on / on / off, one server each on the same weights.
    off, _ = _serving_server(base)
    weights = off.engine.runner.model.state_dict()
    on, seen = _serving_server(dataclasses.replace(base, async_scheduling=True),
                               params=weights)
    runs, tokens = [], {}
    for label, server in (("off", off), ("on", on), ("on", on), ("off", off)):
        r, toks = _mode_run(server, prompts, n_new, seen if server is on else None)
        r["async"] = label
        if label in tokens:
            r["bf16_agreement_with_first_" + label] = _agreement(toks, tokens[label])
        tokens.setdefault(label, toks)
        if label == "on":
            r["bf16_agreement_with_off"] = _agreement(toks, tokens["off"])
        runs.append(r)
        log("[modes] (a) async " + json.dumps(r))
    for r in runs:
        if r["async"] == "on" and (r["chained_share"] <= 0
                                   or not r["chained_dispatches"]):
            fail(f"async run never chained: {r}")
        for k in ("K1 paged_attention", "K2 flash_fwd"):
            if r["launches"][k] <= 0:
                fail(f"(a) {k} was not launched in an async {r['async']} run")
    summary["async"] = runs
    # Why nothing overlaps: one more async run under torch.profiler gives
    # the card's busy time per decode dispatch, beside the host's enqueue.
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        r, _ = _mode_run(on, prompts, n_new, seen)
    busy_ms = sum(e.self_device_time_total for e in prof.key_averages()) / 1e3
    dispatches = len(seen["enqueue_s"])
    summary["async_profiled"] = {
        "device_busy_ms": busy_ms, "wall_s": n_new * len(prompts) / r["tokens_per_s"],
        "decode_dispatches": dispatches,
        "device_busy_ms_per_dispatch": busy_ms / max(dispatches, 1),
        "decode_async_enqueue_p50_ms": (r["decode_async_enqueue_p50_s"] or 0) * 1e3,
    }
    log("[modes] (a) async profiled " + json.dumps(summary["async_profiled"]))
    summary["decode_async_enqueue"] = _decode_async_enqueue_check(on.engine.runner)
    log("[modes] decode_async enqueue: " + json.dumps(summary["decode_async_enqueue"]))
    # The speculation sets without speculation: (b)'s yardstick.
    plain_sets = {}
    for name, ps in sets.items():
        r, plain_sets[name] = _mode_run(off, ps, n_new)
        summary[f"off {name}"] = r
        log(f"[modes] (b) off {name} " + json.dumps(r))
    _free(off, on)

    # (b) speculation: ngram k = 4, a 2-layer draft at k = 8.
    spec_runs = {}
    for mode, k in (("ngram", 4), ("draft", 8)):
        ecfg = dataclasses.replace(base, speculation=mode, num_speculative_tokens=k,
                                   draft_model_config=(gpt2_125m(num_layers=2)
                                                       if mode == "draft" else None))
        server, seen = _serving_server(ecfg, params=weights)
        for name, ps in sets.items():
            r, toks = _mode_run(server, ps, n_new, seen)
            r.update(mode=mode, k=k, prompts=name,
                     tokens_per_s_over_off=(r["tokens_per_s"]
                                            / summary[f"off {name}"]["tokens_per_s"]),
                     bf16_agreement_with_off=_agreement(toks, plain_sets[name]))
            spec_runs[f"{mode} k={k} {name}"] = r
            log(f"[modes] (b) {mode} k={k} {name} " + json.dumps(r))
            if r["verify_steps"] <= 0:
                fail(f"(b) {mode} {name}: no verify step ran")
            if k == 8:
                wide = r["verify_routes"].get(9, {})
                narrow = {w: v for w, v in r["verify_routes"].items() if w <= 8}
                if wide.get("suffix_mma", 0) <= 0 or not any(
                        v.get("split", 0) > 0 for v in narrow.values()):
                    fail(f"(b) verify at k=8 did not launch both K1 routes: "
                         f"{r['verify_routes']}")
        _free(server)
    summary["speculation"] = spec_runs

    # (c) async with ngram: every verify step flushes the pipeline.
    server, seen = _serving_server(
        dataclasses.replace(base, async_scheduling=True, speculation="ngram"),
        params=weights)
    r, toks = _mode_run(server, sets["repetitive"], n_new, seen)
    r["bf16_agreement_with_off"] = _agreement(toks, plain_sets["repetitive"])
    log("[modes] (c) async + ngram k=4 repetitive " + json.dumps(r))
    summary["async_ngram"] = r
    _free(server)

    # (d) f32 identity on one deterministic batch (the engines' own
    # generate): the server phase's prompts and the repetitive set.
    batch = prompts + sets["repetitive"]
    f32 = gpt2_125m(dtype=torch.float32)
    ref_engine = LLMEngine(f32, base, seed=0)
    f32_weights = ref_engine.runner.model.state_dict()
    want = ref_engine.generate(batch, max_new_tokens=n_new)
    plain_engine = LLMEngine(gpt2_125m(dtype=torch.float32, attention_impl="reference"),
                             _replace_attn(), params=f32_weights)
    plain = plain_engine.generate(batch, max_new_tokens=n_new)
    modes = {
        "async": (dataclasses.replace(base, async_scheduling=True), None),
        "ngram k=4": (dataclasses.replace(base, speculation="ngram"), None),
        "draft k=8 (target weights)": (dataclasses.replace(
            base, speculation="draft", num_speculative_tokens=8,
            draft_model_config=f32), f32_weights),
        "async + ngram k=4": (dataclasses.replace(
            base, async_scheduling=True, speculation="ngram"), None),
    }
    identity = {"sync kernel path == plain path": want == plain}
    findings = []
    if want != plain:
        findings.append(("plain", plain))
    for label, (ecfg, draft_params) in modes.items():
        eng = LLMEngine(f32, ecfg, params=f32_weights, draft_params=draft_params)
        _k1_zero()
        got = eng.generate(batch, max_new_tokens=n_new)
        stats, launched = eng.stats(), _k1_read()
        entry = {"identical": got == want, "K1 launches": launched["K1 paged_attention"],
                 "K1 routes": launched["K1 routes"]}
        if ecfg.speculation != "off":
            entry.update(proposed=stats["spec_proposed_tokens"],
                         accepted=stats["spec_accepted_tokens"],
                         verify_steps=stats["spec_verify_steps"])
        if ecfg.async_scheduling:
            chained = [r for r in eng.flight_recorder.snapshot()["steps"] if r["chained"]]
            entry["chained_steps"] = len(chained)
        log(f"[modes] (d) f32 {label}: " + json.dumps(entry))
        identity[label] = entry
        if got != want:
            findings.append((label, got))
        if label.startswith("draft") and stats["spec_accepted_tokens"] != stats[
                "spec_proposed_tokens"]:
            fail(f"(d) draft with the target's weights accepted "
                 f"{stats['spec_accepted_tokens']} of {stats['spec_proposed_tokens']}")
        if launched["K1 paged_attention"] <= 0:
            fail(f"(d) {label}: K1 was not launched")
        del eng
        torch.cuda.empty_cache()
    for label, got in findings:
        for i, (x, y) in enumerate(zip(got, want)):
            if x != y:
                j = next(t for t, (a, b) in enumerate(zip(x + [None], y + [None]))
                         if a != b)
                margin = _top2_margin(plain_engine.runner.model, batch[i], y, j)
                log(f"[modes] (d) f32 {label} differs on request {i} at token {j} "
                    f"(top-2 logit margin there {margin:.3g})")
        fail(f"(d) f32 {label} is not token-identical to the sync kernel path")
    summary["f32_identity"] = identity
    del ref_engine, plain_engine
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    summary["wall_s"] = time.perf_counter() - t_phase
    log(f"[modes] f32 token-identical: async, ngram k=4, draft k=8 (accepted == "
        f"proposed), async + ngram ({len(batch)} requests x {n_new} tokens); "
        f"phase wall {summary['wall_s']:.1f}s")
    return summary


def _host_weights(cfg) -> dict:
    """The seed-0 GPT-2 weights of the server phases (the same init on the
    card), copied to the host: a Serve app takes host arrays, and its
    engine moves them onto the card once."""
    from ray_tpu_torch.models.gpt import GPT

    model = GPT(cfg, device="cuda", seed=0)
    host = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    del model
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return host


def _http(addr, app, payload, stream=False):
    """POST to the proxy: (the result's token ids, None), or (the ndjson
    stream's token ids, the time to the first one)."""
    import urllib.request

    host, port = addr
    req = urllib.request.Request(
        f"http://{host}:{port}/{app}" + ("?stream=1" if stream else ""),
        data=json.dumps(payload).encode(), headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=120) as resp:
        if not stream:
            return json.loads(resp.read())["result"]["token_ids"], None
        toks, first = [], None
        for line in resp:
            if line.strip():
                item = json.loads(line)
                if "error" in item:
                    raise RuntimeError(f"stream failed: {item['error']}")
                first = first if first is not None else time.perf_counter() - t0
                toks.append(item["result"]["token_id"])
        return toks, first


def _serve_request(handle, addr, app, prompt, n_new, how):
    """One request by `how` (handle / handle_stream / http / http_stream)
    → (token ids, client-side TTFT for the streaming ways, else None)."""
    req = {"prompt_ids": [int(t) for t in prompt], "max_new_tokens": n_new}
    if how == "handle":
        return handle.remote(req).result(timeout_s=120)["token_ids"], None
    if how == "handle_stream":
        t0 = time.perf_counter()
        toks, first = [], None
        for item in handle.options(stream=True).remote(dict(req, stream=True)):
            first = first if first is not None else time.perf_counter() - t0
            toks.append(item["token_id"])
        return toks, first
    stream = how == "http_stream"
    return _http(addr, app, dict(req, stream=stream), stream=stream)


SERVE_WAYS = ("handle", "handle", "handle_stream", "handle_stream",
              "http", "http", "http_stream", "http_stream")


def _serve_traffic(handle, addr, prompts, n_new) -> tuple:
    """Every prompt from its own thread, each by its SERVE_WAYS way, all at
    once: (token lists, TTFTs of the streaming ways, wall seconds)."""
    results, ttft = [None] * len(prompts), [None] * len(prompts)

    def client(i):
        results[i], ttft[i] = _serve_request(handle, addr, "llm", prompts[i],
                                             n_new, SERVE_WAYS[i])

    threads = [threading.Thread(target=client, args=(i,)) for i in range(len(prompts))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    torch.cuda.synchronize()
    return results, ttft, time.perf_counter() - t0


def phase_serve(server: dict) -> dict:
    """GPT-2 125M served through Serve: serve.run(build_app(...)) with two
    ingress replicas in front of one engine actor, and the HTTP proxy.
    (1) bf16: the server phase's 8 prompts x 32 tokens at once, 4 through
    the handle and 4 over HTTP, with K1's and K2's counters zeroed just
    before and read just after; tokens/s, TTFT and step p50 beside the
    in-process server's (`server`, the server phase's summary). (2) f32:
    the same 8 requests one at a time must be token-identical to an
    in-process f32 LLMServer on the same weights; then a stream whose
    replica is killed after 8 tokens must resume contiguous and identical.
    (3) the engine's observability and autoscaling snapshots."""
    t_phase = time.perf_counter()
    summary = _serve_apps(server)
    # Measured here, once _serve_apps' locals (handles, the killed
    # replica's handle, the stream) are gone: what still holds the old
    # runtime holds its engines and their card memory. The handles'
    # router threads end within a poll period of the runtime's shutdown.
    mib = 2 ** 20
    mem0 = summary["memory"]["before_mib"] * mib
    t0 = time.perf_counter()
    left = _settle(mem0, "serve") * mib
    summary["left_allocated_mib"] = left / mib
    summary["wall_s"] = time.perf_counter() - t_phase
    log(f"[serve] shut down: {left / mib:.0f} MiB left allocated on the card "
        f"({mem0 / mib:.0f} before serve.run), "
        f"{time.perf_counter() - t0:.1f}s after shutdown; phase wall "
        f"{summary['wall_s']:.1f}s")
    return summary


def _serve_apps(server: dict) -> dict:
    """phase_serve's (1)-(3), from the runtime's start to its shutdown."""
    import ray_tpu_torch
    from ray_tpu_torch import serve
    from ray_tpu_torch.llm import LLMServer
    from ray_tpu_torch.llm.serve import build_app, llm_stream_resume
    from ray_tpu_torch.models.gpt import gpt2_125m
    from ray_tpu_torch.serve._private.controller import get_or_create_controller
    from ray_tpu_torch.serve._private.http_proxy import start_proxy, stop_proxy

    n_new = 32
    prompts = _prompts(np.random.RandomState(0))
    host = _host_weights(gpt2_125m())
    mib = 2 ** 20
    summary = {}
    ray_tpu_torch.init(num_cpus=8, num_gpus=1)
    try:
        # (1) bf16 through the handle and the proxy.
        gc.collect()
        torch.cuda.empty_cache()
        mem0 = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        handle = serve.run(build_app(gpt2_125m(), _engine_config(), params=host,
                                     num_replicas=2, engine_name="smoke-bf16"),
                           name="llm")
        addr = start_proxy()
        # Blocks until the engine actor's __init__ (load + warmup) is done.
        warm, _ = _serve_request(handle, addr, "llm", prompts[5], 4, "handle")
        up_s = time.perf_counter() - t0
        mem1 = torch.cuda.memory_allocated()
        engine = ray_tpu_torch.get_actor("llm_engine:smoke-bf16")
        m0 = ray_tpu_torch.get(engine.metrics.remote())
        weight_bytes = sum(v.numel() * (4 if "norm" in k or "ln" in k else 2)
                           for k, v in host.items())
        mem = {"before_mib": mem0 / mib, "after_mib": mem1 / mib,
               "added_mib": (mem1 - mem0) / mib,
               "kv_pool_bytes": m0["kv_pool_bytes"],  # K and V together
               "kv_pools_mib": m0["kv_pool_bytes"] / mib,
               "bf16_weights_mib": weight_bytes / mib}
        log(f"[serve] bf16 app up in {up_s:.1f}s (2 replicas, 1 engine): "
            + json.dumps(mem))
        # The weights sit on the card once: what serve.run added beside the
        # pools is one bf16 copy of the weights and small buffers, never two.
        extra = mem1 - mem0 - m0["kv_pool_bytes"]
        if not weight_bytes * 0.9 <= extra < weight_bytes * 2:
            fail(f"serve.run added {extra / mib:.0f} MiB beside the pools for "
                 f"{weight_bytes / mib:.0f} MiB of weights")
        if len(warm) != 4:
            fail(f"the warm request gave {len(warm)} tokens, not 4")
        last_step = max((r["step"] for r in ray_tpu_torch.get(
            engine.flight_record.remote())["steps"]), default=-1)
        hits0 = m0["prefix_cache_hit_tokens"]

        _k1_zero()
        results, ttft, wall = _serve_traffic(handle, addr, prompts, n_new)
        counts = _k1_read()
        torch.cuda.synchronize()
        m = ray_tpu_torch.get(engine.metrics.remote())
        steps = [r["duration_s"] for r in ray_tpu_torch.get(
            engine.flight_record.remote())["steps"] if r["step"] > last_step]
        if any(r is None or len(r) != n_new for r in results):
            fail(f"not every serve request finished with {n_new} tokens: "
                 f"{[None if r is None else len(r) for r in results]}")
        if m["prefix_cache_hit_tokens"] - hits0 <= 0:
            fail("the prefix cache never hit through serve")
        launches = {k: counts[k] for k in ("K1 paged_attention", "K2 flash_fwd")}
        for name, n in launches.items():
            if n <= 0:
                fail(f"{name} was not launched through serve.run(build_app(...))")
        stream_ttft = [t for t in ttft if t is not None]
        agree = _agreement(results, server["bf16_tokens"])
        # The card's busy share through Serve: the same traffic again (the
        # engine's prefix cache reset, so the same programs run) under
        # torch.profiler, as the server phase measures it.
        from torch.profiler import ProfilerActivity, profile

        ray_tpu_torch.get(engine.reset_prefix_cache.remote())
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _, _, wall_p = _serve_traffic(handle, addr, prompts, n_new)
        busy_s = sum(e.self_device_time_total for e in prof.key_averages()
                     if e.self_device_time_total > 0) / 1e6
        line = {
            "requests": {way: SERVE_WAYS.count(way) for way in dict.fromkeys(SERVE_WAYS)},
            "tokens": n_new * len(prompts), "wall_s": wall,
            "tokens_per_s": n_new * len(prompts) / wall,
            "ttft_p50_s": statistics.median(stream_ttft),
            "step_p50_s": statistics.median(steps), "steps": len(steps),
            "launches": launches, "k1_routes": counts["K1 routes"],
            "prefix_cache_hit_tokens": m["prefix_cache_hit_tokens"] - hits0,
            "profiled_wall_s": wall_p, "device_busy_share": busy_s / wall_p,
            "in_process": {k: server[k] for k in (
                "tokens_per_s", "ttft_p50_s", "step_p50_s", "steps", "launches",
                "device_busy_share")},
            "bf16_agreement_with_in_process": agree,
        }
        log("[serve] " + json.dumps(line))
        summary.update(line, memory=mem, up_s=up_s)

        # (2) f32: one request at a time by each way, against an in-process
        # f32 server on the same weights; then the killed-replica stream.
        f32_cfg = gpt2_125m(dtype=torch.float32)
        handle32 = serve.run(build_app(f32_cfg, _engine_config(), params=host,
                                       num_replicas=2, engine_name="smoke-f32"),
                             name="llm32")
        _serve_request(handle32, addr, "llm32", prompts[5], 4, "handle")  # warm
        local = LLMServer(f32_cfg, _engine_config(), params=host)
        want = _sequential(local, prompts, n_new)
        _free(local)
        del local
        got = [_serve_request(handle32, addr, "llm32", p, n_new,
                              SERVE_WAYS[(2 * i) % len(SERVE_WAYS)])[0]
               for i, p in enumerate(prompts)]
        if got != want:
            bad = [i for i, (x, y) in enumerate(zip(got, want)) if x != y]
            fail(f"f32 through serve differs from the in-process server on {bad}")
        k = 6
        gen = handle32.options(stream=True, stream_resume_fn=llm_stream_resume).remote(
            {"prompt_ids": [int(t) for t in prompts[k]], "max_new_tokens": n_new,
             "stream": True})
        it = iter(gen)
        resumed = [next(it)["token_id"] for _ in range(8)]
        victim = gen.replica_tag
        _, replicas = ray_tpu_torch.get(
            get_or_create_controller().get_replica_snapshot.remote("llm32", "LLMIngress"))
        ray_tpu_torch.kill(replicas[victim])
        resumed += [item["token_id"] for item in it]
        if resumed != want[k] or gen.replica_tag == victim:
            fail(f"the stream resumed after its replica's kill is not the "
                 f"in-process f32 run (moved: {gen.replica_tag != victim}, "
                 f"{len(resumed)} tokens)")
        log(f"[serve] f32 token-identical to the in-process server ({len(prompts)} "
            f"requests x {n_new} tokens, one at a time, handle and HTTP); the "
            f"stream whose replica {victim} was killed after 8 tokens resumed on "
            f"{gen.replica_tag}, contiguous and identical")

        # (3) the engine's snapshots, read on the card.
        obs = ray_tpu_torch.get(engine.observability_snapshot.remote())
        auto = ray_tpu_torch.get(engine.autoscaling_snapshot.remote())
        log("[serve] snapshots: " + json.dumps({
            "observability_bytes": len(json.dumps(obs, default=str)),
            "observability_keys": sorted(obs),
            "flight_record_steps": len(obs["flight_record"]["steps"]),
            "histograms": sorted(obs["histograms"]),
            "autoscaling_bytes": len(json.dumps(auto, default=str)),
            "autoscaling_keys": sorted(auto)}))
        for name in ("smoke-bf16", "smoke-f32"):
            ray_tpu_torch.get(ray_tpu_torch.get_actor(f"llm_engine:{name}")
                              .shutdown.remote())
    finally:
        serve.shutdown()
        stop_proxy()
        ray_tpu_torch.shutdown()
    return summary


LOADGEN_RATE = 6.0
LOADGEN_REQUESTS = 24
LOADGEN_CELLS = ("base", "async_step", "spec_ngram", "int8_kv")
LOADGEN_REPEATS = 3  # base in all
# Prompts long enough for K2's full prefill (and chunked prefill past 256
# tokens), multiturn sessions sharing a 64-token prefix (K1's suffix
# kernel on prefix hits), 24-32 new tokens a request.
LOADGEN_SCENARIO = dict(max_new_tokens=32, prompt_len_median=128.0, output_len_median=24.0,
                        shared_prefix_len=64, turn_tokens=32)


def _count_cells(sweep, driver, runner_cls):
    """Instrument the sweep for the card run (module attributes, restored
    by the returned function): K1's and K2's counters are set to 0 just
    before each cell's open-loop run and read just after it (the app's
    warmup and priming request stay out), with K1's launches inside
    GPTRunner.verify counted apart; each cell record gets the counts as
    `launches`."""
    runs = []
    saved = {"run_open_loop": driver.run_open_loop, "verify": runner_cls.verify}
    verify = {"calls": 0, "k1": 0}

    def verify_counted(self, *args, **kwargs):
        from ray_tpu_torch.ops.paged_flash import paged_flash_attention

        before = paged_flash_attention.launches
        try:
            return saved["verify"](self, *args, **kwargs)
        finally:
            verify["calls"] += 1
            verify["k1"] += paged_flash_attention.launches - before

    def run_open_loop(*args, **kwargs):
        _k1_zero()
        verify.update(calls=0, k1=0)
        result = saved["run_open_loop"](*args, **kwargs)
        torch.cuda.synchronize()
        runs.append(dict(_k1_read(), verify=dict(verify)))
        return result

    def counted(fn):
        def run(*args, **kwargs):
            gc.collect()
            torch.cuda.empty_cache()
            mem0 = torch.cuda.memory_allocated()
            cell = fn(*args, **kwargs)
            cell["launches"] = runs.pop()
            # What the cell left allocated on the card after its teardown.
            cell["left_allocated_mib"] = _settle(mem0, f"loadgen {cell.get('cell', fn.__name__)}")
            return cell
        return run

    cells = {name: getattr(sweep, name)
             for name in ("run_cell", "run_drain_cell", "run_collapse_cell",
                          "run_kv_fabric_cell")}
    driver.run_open_loop = run_open_loop
    runner_cls.verify = verify_counted
    for name, fn in cells.items():
        setattr(sweep, name, counted(fn))

    def restore():
        driver.run_open_loop = saved["run_open_loop"]
        runner_cls.verify = saved["verify"]
        for name, fn in cells.items():
            setattr(sweep, name, fn)

    return restore


def _loadgen_line(cell: dict) -> dict:
    """What a cell's `[loadgen]` line prints."""
    rep = cell["report"]
    pct = rep["percentiles"]
    eng = cell["engine"]
    line = {
        "cell": cell["config"], "rate": cell["rate"],
        "offered_per_s": rep["offered_rate"], "achieved_per_s": rep["achieved_rate"],
        "tokens_per_s": rep["tokens_received"] / rep["wall_duration_s"],
        "send_lag_p50_s": rep["send_lag_s"]["p50"], "send_lag_p99_s": rep["send_lag_s"]["p99"],
        "ttft_p50_s": pct["ttft_s"]["p50"], "ttft_p99_s": pct["ttft_s"]["p99"],
        "tpot_p50_s": pct["tpot_s"]["p50"], "tpot_p99_s": pct["tpot_s"]["p99"],
        "e2e_p99_s": pct["e2e_s"]["p99"],
        "requests": rep["requests"], "completed": rep["completed"],
        "disconnected": rep["disconnected"], "errors": rep["errors"],
        "shed": rep["num_shed"], "shed_p99_s": rep["shed_latency_s"]["p99"],
        "prefix_hit_rate": eng.get("prefix_cache_hit_rate"),
        "kv_cache_dtype": cell.get("kv_cache_dtype"),
        "launches": cell["launches"],
        "left_allocated_mib": cell.get("left_allocated_mib"),
    }
    if "cross_check" in cell:
        check = cell["cross_check"]
        line["cross_check"] = {"agreed": check["agreed"], **{
            f"{m}_{q}": [check[m][q].get("loadgen_s"), check[m][q].get("engine_s")]
            for m in ("ttft_s", "tpot_s") if isinstance(check.get(m), dict)
            for q in ("p50", "p99") if q in check[m]}}
    if cell["config"] == "spec_ngram":
        line["acceptance"] = eng.get("spec_acceptance_rate")
        line["tokens_per_verify_step"] = eng.get("spec_tokens_per_verify_step")
    if "burn_rates" in cell:
        line["burn_rates"] = cell["burn_rates"]
    if "drain" in cell:
        line["drain"] = {k: cell["drain"][k] for k in (
            "state_counts", "num_drained_replicas", "num_migrated_requests")}
    if "fabric" in cell:
        fab = cell["fabric"]
        line["fabric"] = {
            "repeat_wave_ttft_p50_s": fab["repeat_wave_ttft_p50_s"],
            "flushed_blocks": fab["flushed_blocks"],
            "cross_replica_hit_blocks": fab["cross_replica_hit_blocks"],
            "store": fab["store"], "per_engine": fab["per_engine"]}
    return line


def _check_cell_launches(cell: dict, knob: bool) -> None:
    launches, name = cell["launches"], cell["config"]
    if launches["K1 paged_attention"] <= 0:
        fail(f"[loadgen] {name}: K1 was not launched in the cell's run")
    if knob and launches["K2 flash_fwd"] <= 0:
        fail(f"[loadgen] {name}: K2 was not launched in the cell's run")
    if name == "spec_ngram" and launches["verify"]["k1"] <= 0:
        fail(f"[loadgen] spec_ngram: K1 was not launched by verify "
             f"({launches['verify']})")
    if name == "int8_kv" and cell.get("kv_cache_dtype") != "int8":
        fail(f"[loadgen] int8_kv ran on {cell.get('kv_cache_dtype')} pools")


def phase_loadgen() -> dict:
    """GPT-2 125M at full width driven open-loop through Serve by the
    port's loadgen: (1) run_sweep on the card with the knob cells base,
    async_step, spec_ngram and int8_kv at 6 requests/s (Poisson, 24
    requests each), then its drain cell (6/s, uniform, 12 requests) and
    collapse cell (a ramp from 6 to 400/s over 64 requests); every gate
    must pass, K1 must launch in every cell and K2 in every knob cell (the
    counters set to 0 just before each cell's open-loop run and read just
    after it), spec_ngram's verify must launch K1 and int8_kv run on int8
    pools; one `[loadgen]` line a cell. (2) base twice more: the median
    and spread of TTFT p50 and tokens/s over the three. (3) the fleet: two
    replicas each with its own engine, 24 longtail requests at 6/s with a
    loose and an impossible burn-rate monitor live, then fleet_snapshot:
    each replica's ledger covers 1 +- 0.05 of its wall, loose burn < 1 <
    impossible; then one request under a client span exported by
    timeline(trace_id=...). (4) card memory left after the shutdown. The
    sweep's KV-fabric pair (kv_fabric_affinity, kv_fabric_p2c) runs after
    the collapse cell: its gate, K1 in each cell's run and no engine or
    `kv_fabric:*` store left alive afterwards."""
    import ray_tpu_torch
    from ray_tpu_torch import serve
    from ray_tpu_torch._private.runtime import get_runtime
    from ray_tpu_torch.llm.model_runner import GPTRunner
    from ray_tpu_torch.loadgen import driver, sweep
    from ray_tpu_torch.models.gpt import gpt2_125m
    from ray_tpu_torch.util.runtime_metrics import list_llm_engine_actors

    t_phase = time.perf_counter()
    cfg = gpt2_125m()
    host = _host_weights(cfg)
    served = dict(device="cuda", model_config=cfg, params=host,
                  engine_base=dict(ENGINE_BASE), scenario_overrides=dict(LOADGEN_SCENARIO))
    gc.collect()
    torch.cuda.empty_cache()
    mem0 = torch.cuda.memory_allocated()
    summary = {}
    ray_tpu_torch.init(num_cpus=8, num_gpus=1)
    restore = _count_cells(sweep, driver, GPTRunner)
    try:
        # (1) the sweep.
        record, problems = sweep.run_sweep([LOADGEN_RATE], LOADGEN_REQUESTS,
                                           configs=list(LOADGEN_CELLS), **served)
        lines = []
        for cell in record["cells"]:
            line = _loadgen_line(cell)
            lines.append(line)
            log("[loadgen] " + json.dumps(line))
        log(f"[loadgen] sweep on {record['device_name']} ({record['backend']}): "
            f"{len(record['cells'])} cells, note: {record['note']}")
        if problems:
            fail(f"[loadgen] the sweep's gates failed: {problems}")
        want = [c[0] for c in sweep.KNOB_CONFIGS if c[0] in LOADGEN_CELLS]
        if [c["config"] for c in record["cells"]] != want + [
                "drain_scale_down", "collapse_ramp", "kv_fabric_affinity",
                "kv_fabric_p2c"]:
            fail(f"[loadgen] unexpected cells {[c['config'] for c in record['cells']]}")
        for cell in record["cells"]:
            if cell["model"]["embed_dim"] != 768 or cell["device"] != "cuda":
                fail(f"[loadgen] {cell['config']} did not serve GPT-2 125M on the card")
            _check_cell_launches(cell, knob=cell["config"] in LOADGEN_CELLS)
            if "fabric" in cell:
                for name, eng in cell["fabric"]["per_engine"].items():
                    if eng["fabric_timeouts"]:
                        fail(f"[loadgen] {cell['config']}: {name} timed out on "
                             f"the fabric store {eng['fabric_timeouts']} times")
        summary["cells"] = lines

        # (2) base, twice more.
        base = [record["cells"][0]]
        for _ in range(LOADGEN_REPEATS - 1):
            cell = sweep.run_cell("base", {}, False, LOADGEN_RATE, LOADGEN_REQUESTS, 0,
                                  **served)
            gate = sweep._gate(cell)
            log("[loadgen] " + json.dumps(dict(_loadgen_line(cell), repeat=len(base))))
            if gate:
                fail(f"[loadgen] base repeat {len(base)}: {gate}")
            _check_cell_launches(cell, knob=True)
            base.append(cell)
        spread = {}
        for key in ("ttft_p50_s", "tokens_per_s"):
            vals = [_loadgen_line(c)[key] for c in base]
            spread[key] = {"runs": vals, "median": statistics.median(vals),
                           "min": min(vals), "max": max(vals),
                           "spread": (max(vals) - min(vals)) / statistics.median(vals)}
        log("[loadgen] base x3: " + json.dumps(spread))
        summary["base_repeats"] = spread
        # Every cell ends its app and kills its engines (ROADMAP §D8,
        # §D10), the fabric pair its store too: nothing of the cells may be
        # alive when the fleet starts.
        left = list_llm_engine_actors(get_runtime())
        stores = sorted(sweep._live_actors("kv_fabric:"))
        if left or stores:
            fail(f"[loadgen] the cells left engines {left} and stores {stores} behind")

        # (3) the fleet view.
        summary["fleet"] = _loadgen_fleet(cfg, host)
    finally:
        restore()
        serve.shutdown()
        ray_tpu_torch.shutdown()
    mib = 2 ** 20
    t0 = time.perf_counter()
    left = _settle(mem0, "loadgen") * mib
    summary["left_allocated_mib"] = left / mib
    summary["wall_s"] = time.perf_counter() - t_phase
    log(f"[loadgen] shut down: {left / mib:.0f} MiB left allocated on the card "
        f"({mem0 / mib:.0f} before), {time.perf_counter() - t0:.1f}s after shutdown; "
        f"phase wall {summary['wall_s']:.1f}s")
    return summary


def _loadgen_fleet(cfg, host) -> dict:
    """phase_loadgen's (3): the fleet ledger, the burn pair and one
    request's timeline, on two replicas with an engine each."""
    import tempfile

    import ray_tpu_torch
    from ray_tpu_torch import serve
    from ray_tpu_torch.llm.serve import build_app
    from ray_tpu_torch.loadgen import (IMPOSSIBLE_SLO, LOOSE_SLO, ArrivalSpec, ScenarioSpec,
                                       arrival_times, build_report, generate_requests,
                                       run_open_loop)
    from ray_tpu_torch.observability import SLOBurnRateMonitor, fleet_snapshot
    from ray_tpu_torch.util import tracing

    ecfg = _engine_config()
    handle = serve.run(build_app(cfg, ecfg, params=host, engine_name="smoke-fleet",
                                 num_replicas=2, engine_per_replica=True, device="cuda"),
                       name="fleet")
    warm = handle.remote({"prompt_ids": [1, 2, 3], "max_new_tokens": 2}).result(timeout_s=300)
    if len(warm["token_ids"]) != 2:
        fail("[fleet] the warm request did not finish")
    spec = ScenarioSpec.for_engine(ecfg.max_model_len, ecfg.buckets()[-1],
                                   vocab_size=cfg.vocab_size, name="longtail",
                                   num_requests=LOADGEN_REQUESTS, seed=0,
                                   **LOADGEN_SCENARIO)
    requests = generate_requests(spec)
    offsets = arrival_times(ArrivalSpec(rate=LOADGEN_RATE, seed=0), len(requests))
    monitors = {s.name: SLOBurnRateMonitor(s, windows=(5.0, 60.0)) for s in
                (LOOSE_SLO, IMPOSSIBLE_SLO)}
    for mon in monitors.values():
        mon.sample()  # the baseline before traffic
        mon.start(interval_s=0.25)
    # The card's busy time under the same traffic (torch.profiler, CUDA
    # activity only), to read beside the ledger's device_s column, which
    # also holds the host's enqueue of each step and the blocking copy.
    from torch.profiler import ProfilerActivity, profile

    _k1_zero()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            result = run_open_loop(handle, requests, offsets, timeout_s=30.0,
                                   settle_timeout_s=60.0)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        for mon in monitors.values():
            try:
                mon.sample()
            finally:
                mon.stop()
    launches = _k1_read()
    busy_s = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.self_device_time_total > 0) / 1e6
    burns = {name: mon.peak_burn() for name, mon in monitors.items()}
    rep = build_report(result)
    snap = fleet_snapshot(steps_limit=4096, timeout_s=10.0,
                          peak_flops_per_s=PEAK_FLOPS[torch.bfloat16])
    out = {"report": {k: rep[k] for k in ("requests", "completed", "errors",
                                          "achieved_rate", "send_lag_s")},
           "burn_peaks": burns, "launches": launches, "replicas": {},
           "profiled_wall_s": wall, "device_busy_s": busy_s,
           "device_busy_share": busy_s / wall}
    if rep["completed"] != len(requests):
        fail(f"[fleet] {rep['requests'] - rep['completed']} requests did not "
             f"complete: {rep['errors']}")
    if len(snap["replicas"]) != 2:
        fail(f"[fleet] fleet_snapshot saw {sorted(snap['replicas'])}, not 2 engines")
    for name, row in snap["replicas"].items():
        if "error" in row:
            fail(f"[fleet] {name}: {row['error']}")
        led = row["ledger"]
        out["replicas"][name] = {
            "steps": led["steps"], "wall_s": led["wall_s"], "coverage": led["coverage"],
            "fractions": led["fractions"], "goodput_tokens_per_s": led["goodput_tokens_per_s"],
            "mfu": led["mfu"], "host_gap_s": led["host_gap_s"],
            "committed_tokens": led["committed_tokens"], "model_params": row["model_params"]}
        if led["coverage"] is None or not 0.95 <= led["coverage"] <= 1.05:
            fail(f"[fleet] {name}: ledger coverage {led['coverage']} outside 1 +- 0.05")
    merged = snap["percentiles"].get("llm_request_ttft_seconds", {})
    out["merged_ttft"] = merged
    out["fleet"] = {k: snap["fleet"][k] for k in (
        "fractions", "bottlenecks", "goodput_tokens_per_s", "min_coverage",
        "max_coverage", "mfu", "committed_tokens")}
    if not burns["loose"] < 1.0 < burns["impossible"]:
        fail(f"[fleet] burn rates loose {burns['loose']} / impossible "
             f"{burns['impossible']}: want loose < 1 < impossible")
    if launches["K1 paged_attention"] <= 0 or launches["K2 flash_fwd"] <= 0:
        fail(f"[fleet] kernels not launched by the fleet's traffic: {launches}")
    for name, row in out["replicas"].items():
        log(f"[fleet] {name}: " + json.dumps(row))
    log("[fleet] " + json.dumps({k: v for k, v in out.items() if k != "replicas"}))

    # One request's timeline across handle, replica and engine.
    with tracing.span("client") as root:
        with tracing.span("serve.handle.request"):
            res = handle.remote({"prompt_ids": requests[0].prompt_ids[:64],
                                 "max_new_tokens": 4}).result(timeout_s=60)
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/trace.json"
        ray_tpu_torch.timeline(path, trace_id=root.trace_id)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    rows = {e["args"]["name"] for e in events
            if e["ph"] == "M" and e["name"] == "process_name"}
    flows = sum(e["ph"] == "s" for e in events)
    slices = sum(e["ph"] == "X" for e in events)
    if len(res["token_ids"]) != 4 or not {"serve.handle", "serve.replica",
                                          "llm.engine"} <= rows or not flows:
        fail(f"[fleet] the request's timeline lacks rows or flows: {sorted(rows)}, "
             f"{flows} flows")
    log(f"[fleet] timeline(trace_id=...): {slices} slices, {flows} flow arrows, "
        f"rows {sorted(rows)}")
    out["timeline"] = {"slices": slices, "flows": flows, "rows": sorted(rows)}
    return out


# Phase 11's fabrics: every block the 8 prompts and their replies fill
# (~110 at block size 16: 65 MB in bf16, 130 MB in f32) fits, so no
# restore misses for want of room.
FABRIC_BUDGET = 256 << 20
FABRIC_STEP_PROGRAMS = ("prefill", "prefill_suffix", "decode", "decode_async", "verify")


def _count_by_role(runner_cls) -> tuple:
    """Wrap GPTRunner's step programs (class attributes, restored by the
    returned function) to add each call's K1 and K2 launches to the count
    of its engine's role: the disaggregated pair's two engines run in one
    process and take turns (the prefill reply is the barrier), so a call's
    counter delta is its own."""
    from ray_tpu_torch.ops.flash_attention import flash_attention_fwd
    from ray_tpu_torch.ops.paged_flash import paged_flash_attention

    counts = {}
    saved = {name: getattr(runner_cls, name) for name in FABRIC_STEP_PROGRAMS}

    def counted(fn):
        def call(self, *args, **kwargs):
            k1, k2 = paged_flash_attention.launches, flash_attention_fwd.launches
            try:
                return fn(self, *args, **kwargs)
            finally:
                role = counts.setdefault(self.engine_config.engine_role,
                                         {"K1 paged_attention": 0, "K2 flash_fwd": 0})
                role["K1 paged_attention"] += paged_flash_attention.launches - k1
                role["K2 flash_fwd"] += flash_attention_fwd.launches - k2
        return call

    for name, fn in saved.items():
        setattr(runner_cls, name, counted(fn))

    def restore():
        for name, fn in saved.items():
            setattr(runner_cls, name, fn)

    return counts, restore


def _fabric_round_trip(kv: str) -> dict:
    """Phase 11 (a): a full-width block extracted from a `kv` pool and
    restored into another slot: the pools' bytes equal, the payload host
    numpy of kv_block_bytes() bytes; each copy's time per block."""
    from ray_tpu_torch.llm import EngineConfig, GPTRunner
    from ray_tpu_torch.llm.kvfabric import payload_nbytes
    from ray_tpu_torch.models.gpt import gpt2_125m

    runner = GPTRunner(gpt2_125m(), EngineConfig(**{**ENGINE_BASE, "num_blocks": 64},
                                                 kv_cache_dtype=kv), seed=0)
    prompt = list(np.random.RandomState(1).randint(0, 50257, 3 * BS))
    runner.prefill(prompt, [1, 2, 3])
    payload = runner.extract_block(2)
    arrays = {k: v for k, v in payload.items() if k != "kv_dtype"}
    if not all(isinstance(v, np.ndarray) for v in arrays.values()):
        fail(f"[fabric] {kv}: the payload is not host numpy: "
             f"{ {k: type(v).__name__ for k, v in arrays.items()} }")
    if payload_nbytes(payload) != runner.kv_block_bytes():
        fail(f"[fabric] {kv}: payload of {payload_nbytes(payload)} bytes, a block is "
             f"{runner.kv_block_bytes()}")
    runner.restore_block(7, payload)
    torch.cuda.synchronize()
    back = runner.extract_block(7)
    for key, val in arrays.items():
        if back[key].dtype != val.dtype or back[key].tobytes() != val.tobytes():
            fail(f"[fabric] {kv}: {key} not bit-identical after the round trip")
    for pool in (runner.k_cache, runner.v_cache, runner.k_scale, runner.v_scale):
        if pool is not None and not torch.equal(pool[:, 2], pool[:, 7]):
            fail(f"[fabric] {kv}: the restored slot differs from its source on the card")
    reps = 20
    t0 = time.perf_counter()
    for _ in range(reps):
        runner.extract_block(2)
    extract_ms = (time.perf_counter() - t0) / reps * 1e3
    t0 = time.perf_counter()
    for _ in range(reps):
        runner.restore_block(7, payload)
    torch.cuda.synchronize()
    restore_ms = (time.perf_counter() - t0) / reps * 1e3
    row = {"kv_cache_dtype": kv, "block_bytes": runner.kv_block_bytes(),
           "arrays": {k: f"{v.dtype}{list(v.shape)}" for k, v in arrays.items()},
           "extract_ms": extract_ms, "restore_ms": restore_ms}
    del runner
    torch.cuda.empty_cache()
    return row


def phase_fabric() -> dict:
    """Phase 11, the KV fabric at GPT-2 125M's full width on the server
    phase's (seed-0) weights. (a) A block round trip from a bf16 and an
    int8 pool. (b) Spill and cold restore: server A serves the server
    phase's 8 prompts and flushes into the fabric; a fresh server B on the
    same fabric serves them again from restores (K1 launched on B's run,
    restores > 0 and at most sum((n - 1) // bs), no store timeout, every
    payload read back host numpy, neither warmup touching the store); the
    same in f32, where B's tokens must equal A's and a fabric-off engine's.
    (c) DisaggregatedLLM in f32 with both engines on the card: tokens equal
    a unified engine's, K2 launched by the prefill engine and K1 by the
    decode engine, (n - 1) // bs blocks restored a request; the handoff's
    TTFT beside the unified engine's. (d) Nothing left alive; card memory."""
    import ray_tpu_torch
    from ray_tpu_torch._private.runtime import get_runtime
    from ray_tpu_torch.llm import EngineConfig, GPTRunner, KVFabricConfig, LLMEngine, LLMServer
    from ray_tpu_torch.llm.kvfabric import DisaggregatedLLM, KVFabricClient
    from ray_tpu_torch.loadgen.sweep import _live_actors
    from ray_tpu_torch.models.gpt import gpt2_125m
    from ray_tpu_torch.util.runtime_metrics import list_llm_engine_actors

    t_phase = time.perf_counter()
    n_new = 32
    prompts = _prompts(np.random.RandomState(0))
    restorable = [(len(p) - 1) // BS for p in prompts]
    summary = {"round_trip": [_fabric_round_trip(kv) for kv in ("bf16", "int8")]}
    for row in summary["round_trip"]:
        log("[fabric] round trip " + json.dumps(row))
    gc.collect()
    torch.cuda.empty_cache()
    mem0 = torch.cuda.memory_allocated()

    def fabric_config(name, **extra):
        return EngineConfig(**ENGINE_BASE, kv_fabric=KVFabricConfig(
            name=name, byte_budget=FABRIC_BUDGET), **extra)

    ray_tpu_torch.init(num_cpus=8, num_gpus=1)
    counts, restore = _count_by_role(GPTRunner)
    try:
        # (b) bf16: spill from server A, cold restore on server B.
        client = KVFabricClient("smoke-spill", FABRIC_BUDGET)
        a = LLMServer(gpt2_125m(), fabric_config("smoke-spill"), seed=0)
        warm = client.stats()
        if warm.get("puts") or warm.get("num_blocks") or warm.get("misses"):
            fail(f"[fabric] server A's warmup touched the store: {warm}")
        tokens_a, _, _ = _concurrent(a, prompts, n_new)
        flushed = a.flush_kv_fabric()
        before_b = client.stats()
        b = LLMServer(gpt2_125m(), fabric_config("smoke-spill"), seed=0)
        if client.stats() != before_b:
            fail(f"[fabric] server B's warmup touched the store: {before_b} -> "
                 f"{client.stats()}")
        _k1_zero()
        tokens_b, ttft_b, wall_b = _concurrent(b, prompts, n_new)
        torch.cuda.synchronize()
        launches_b = _k1_read()
        ma, mb = a.metrics(), b.metrics()
        store = client.stats()
        steps = b.flight_record()["steps"]
        restoring = [s for s in steps if s.get("fabric_restored_blocks")]
        hashes = [h for _, h in a.engine.allocator.evictable_items()]
        read_back = client.get_many(hashes[:16])
        _free(a, b)
        del a, b
        spill = {
            "flushed_blocks": flushed, "restorable_blocks": sum(restorable),
            # Spills by eviction inside admission (on_evict), apart from
            # the flush: B had not flushed when its metrics were read.
            "evict_spills": [ma["fabric_spill_blocks"] - flushed, mb["fabric_spill_blocks"]],
            "restore_blocks": mb["fabric_restore_blocks"],
            "hit_blocks": mb["fabric_hit_blocks"],
            "restored_tokens": mb["fabric_restored_tokens"],
            "prefix_cache_hit_tokens": mb["prefix_cache_hit_tokens"],
            "timeouts": [ma["fabric_timeouts"], mb["fabric_timeouts"]],
            "store": store, "launches": launches_b,
            "restoring_steps": len(restoring),
            "fabric_wait_s": [s["fabric_wait_s"] for s in restoring],
            "restored_blocks_by_step": [s["fabric_restored_blocks"] for s in restoring],
            "ttft_p50_s": statistics.median(ttft_b), "wall_s": wall_b,
            "bf16_agreement_with_a": _agreement(tokens_b, tokens_a),
        }
        log("[fabric] bf16 spill and cold restore: " + json.dumps(spill))
        summary["spill_bf16"] = spill
        if not 0 < spill["restore_blocks"] <= sum(restorable):
            fail(f"[fabric] B restored {spill['restore_blocks']} blocks, want 1.."
                 f"{sum(restorable)}")
        if any(spill["timeouts"]):
            fail(f"[fabric] store RPCs timed out: {spill['timeouts']}")
        if store["hits"] < spill["restore_blocks"]:
            fail(f"[fabric] the store served {store['hits']} hits for "
                 f"{spill['restore_blocks']} restores")
        if launches_b["K1 paged_attention"] <= 0:
            fail("[fabric] K1 was not launched on B's run")
        if any(r is None for r in read_back) or not all(
                isinstance(v, np.ndarray) for r in read_back for k, v in r.items()
                if k != "kv_dtype"):
            fail("[fabric] a payload read back from the store is missing or not numpy")
        if any(len(t) != n_new for t in tokens_b):
            fail("[fabric] B did not finish every request")

        # (b) f32: A's tokens, B's from restores and a fabric-off engine's
        # must be equal.
        a32 = LLMEngine(gpt2_125m(dtype=torch.float32), fabric_config("smoke-spill-f32"),
                        seed=0)
        host32 = {k: v.detach().cpu() for k, v in a32.runner.model.state_dict().items()}
        want = a32.generate(prompts, max_new_tokens=n_new)
        a32.flush_kv_fabric()
        b32 = LLMEngine(gpt2_125m(dtype=torch.float32), fabric_config("smoke-spill-f32"),
                        params=host32)
        _k1_zero()
        got = b32.generate(prompts, max_new_tokens=n_new)
        torch.cuda.synchronize()
        launches32 = _k1_read()
        s32 = b32.stats()
        del a32, b32
        torch.cuda.empty_cache()
        off = LLMEngine(gpt2_125m(dtype=torch.float32), _engine_config(), params=host32)
        plain = off.generate(prompts, max_new_tokens=n_new)
        del off
        torch.cuda.empty_cache()
        summary["spill_f32"] = {"restore_blocks": s32["fabric_restore_blocks"],
                                "timeouts": s32["fabric_timeouts"], "launches": launches32}
        log("[fabric] f32 spill and cold restore: " + json.dumps(summary["spill_f32"]))
        if got != want or got != plain:
            fail(f"[fabric] f32 cold restore not token-identical: requests "
                 f"{[i for i, (x, y, z) in enumerate(zip(got, want, plain)) if not x == y == z]}")
        if not 0 < s32["fabric_restore_blocks"] <= sum(restorable) or s32["fabric_timeouts"]:
            fail(f"[fabric] f32 B: {s32['fabric_restore_blocks']} restores, "
                 f"{s32['fabric_timeouts']} timeouts")
        log(f"[fabric] f32 cold restore token-identical to A and to the fabric-off "
            f"engine ({len(prompts)} requests x {n_new} tokens)")

        # (c) disaggregated prefill/decode, f32, both engines on the card.
        distinct = [prompts[i] for i in (0, 1, 3, 5, 6, 7)]  # no shared prefix
        disagg = DisaggregatedLLM(gpt2_125m(dtype=torch.float32),
                                  fabric_config("smoke-disagg"), params=host32,
                                  name="smoke-disagg", device="cuda")
        unified = LLMServer(gpt2_125m(dtype=torch.float32), _engine_config(),
                            params=host32)
        try:
            disagg.generate([1, 2, 3], max_new_tokens=2)  # both engines up
            counts.clear()
            tokens, per_request = [], []
            for p in distinct:
                before = disagg.decode_stats()["fabric_restore_blocks"]
                tokens.append(disagg.generate(p, max_new_tokens=n_new)["token_ids"])
                per_request.append(disagg.decode_stats()["fabric_restore_blocks"] - before)
            role_launches = {k: dict(v) for k, v in counts.items()}
            want_d = _sequential(unified, distinct, n_new)
            # TTFT: fresh prompts of the same lengths, first token only.
            rng = np.random.RandomState(2)
            fresh = [list(rng.randint(0, 50257, len(p))) for p in distinct]
            ttft = {"handoff": [], "unified": []}
            for p in fresh:
                t0 = time.perf_counter()
                disagg.generate(p, max_new_tokens=1)
                ttft["handoff"].append(time.perf_counter() - t0)
                t0 = time.perf_counter()
                unified.generate(p, max_new_tokens=1)
                ttft["unified"].append(time.perf_counter() - t0)
            pstats, dstats = disagg.prefill_stats(), disagg.decode_stats()
        finally:
            disagg.shutdown()
            _free(unified)
        del disagg, unified
        dis = {
            "prompt_lens": [len(p) for p in distinct],
            "restored_per_request": per_request,
            "launches_by_role": role_launches,
            "prefill_spill_blocks": pstats["fabric_spill_blocks"],
            "decode_restore_blocks": dstats["fabric_restore_blocks"],
            "timeouts": [pstats["fabric_timeouts"], dstats["fabric_timeouts"]],
            "ttft_s": ttft,
            "ttft_p50_s": {k: statistics.median(v) for k, v in ttft.items()},
        }
        log("[fabric] disaggregated: " + json.dumps(dis))
        summary["disagg"] = dis
        if tokens != want_d:
            fail(f"[fabric] disaggregated tokens differ from the unified engine's on "
                 f"requests {[i for i, (x, y) in enumerate(zip(tokens, want_d)) if x != y]}")
        if per_request != [(len(p) - 1) // BS for p in distinct]:
            fail(f"[fabric] the decode engine restored {per_request} blocks, want "
                 f"{[(len(p) - 1) // BS for p in distinct]}")
        if role_launches.get("prefill", {}).get("K2 flash_fwd", 0) <= 0:
            fail(f"[fabric] K2 was not launched by the prefill engine: {role_launches}")
        if role_launches.get("decode", {}).get("K1 paged_attention", 0) <= 0:
            fail(f"[fabric] K1 was not launched by the decode engine: {role_launches}")
        if any(dis["timeouts"]):
            fail(f"[fabric] the pair's store RPCs timed out: {dis['timeouts']}")
        log(f"[fabric] disaggregated f32 token-identical to the unified engine "
            f"({len(distinct)} requests x {n_new} tokens)")

        # (d) teardown: the pair's actors are gone; the stores outlive
        # their engines by design, so they are killed here.
        for handle in _live_actors("kv_fabric:").values():
            ray_tpu_torch.kill(handle)
        deadline = time.perf_counter() + 20
        while time.perf_counter() < deadline and (
                list_llm_engine_actors(get_runtime()) or _live_actors("kv_fabric:")):
            time.sleep(0.1)
        left = (list_llm_engine_actors(get_runtime()), sorted(_live_actors("kv_fabric:")))
        if any(left):
            fail(f"[fabric] left alive: engines {left[0]}, stores {left[1]}")
    finally:
        restore()
        ray_tpu_torch.shutdown()
    del host32
    mib = 2 ** 20
    summary["left_allocated_mib"] = _settle(mem0, "fabric")
    summary["wall_s"] = time.perf_counter() - t_phase
    log(f"[fabric] shut down: {summary['left_allocated_mib']:.0f} MiB left allocated on "
        f"the card ({mem0 / mib:.0f} before the servers); phase wall "
        f"{summary['wall_s']:.1f}s")
    return summary


# ResNet training at bench.py's shape (its "Config #2 (headline)"): B256
# 224x224x3, bf16 compute on f32 parameters, 1000 classes, GroupNorm,
# SGD(0.1, momentum 0.9); fwd + bwd counted as 3 x 4.1 GFLOP an image
# (bench.py:349).
RESNET_B, RESNET_HW, RESNET_WARMUP, RESNET_TIMED = 256, 224, 2, 10
RESNET_FLOP_PER_IMAGE = 3 * 4.1e9
RESNET_BATCHNORM_STEPS = 3
# BASELINE.json's first configuration: ResNet-18 on CIFAR-10-sized images.
R18_B, R18_HW, R18_STEPS = 256, 32, 5
# f32 parity of one ResNet-18 small_inputs step, card against the CPU:
# relative L2 bounds (cuDNN's f32 algorithms against the CPU's, no TF32).
RESNET_PARITY_B = 4
RESNET_PARITY_LIMITS = dict(loss=1e-5, grad=1e-4, param=1e-5)


def _profiled(fn, device=None) -> dict:
    """fn() once under torch.profiler: the wall (taken inside the profiled
    block), the card's busy seconds and share, the top five kernels by
    device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    device_us = {e.key: e.self_device_time_total for e in prof.key_averages()
                 if e.self_device_time_total > 0}
    busy = sum(device_us.values()) / 1e6
    top = sorted(device_us.items(), key=lambda kv: -kv[1])[:5]
    return {"wall_s": wall, "device_busy_s": busy, "device_busy_share": busy / wall,
            "top_kernels_ms": [[k[:150], v / 1e3] for k, v in top]}


def _resnet_data(b, hw, device, seed=0):
    """Synthetic ImageNet-shaped data from a seeded generator on `device`:
    NHWC bf16 images and integer labels."""
    gen = torch.Generator(device=device).manual_seed(seed)
    images = torch.randn((b, hw, hw, 3), generator=gen, device=device, dtype=torch.bfloat16)
    labels = torch.randint(0, 1000, (b,), generator=gen, device=device)
    return images, labels


def _resnet_step(model, opt, images, labels):
    """bench.py:317-327's step: softmax cross entropy with integer labels on
    the f32 logits, averaged; optax.sgd(0.1, momentum=0.9), which is
    torch.optim.SGD (its first momentum buffer is the gradient, as optax's
    trace)."""
    loss = torch.nn.functional.cross_entropy(model(images).float(), labels)
    opt.zero_grad(set_to_none=True)
    loss.backward()
    opt.step()
    return loss.detach()


def _layout_probe(model, images, labels) -> dict:
    """One step with hooks on every norm: how many of its inputs and of
    the gradients reaching its output were not channels_last (either would
    make the norm's NHWC view copy)."""
    from ray_tpu_torch.models.resnet import Norm

    seen = {"inputs": 0, "inputs_not_cl": 0, "grads": 0, "grads_not_cl": 0}

    def pre(_module, args):
        seen["inputs"] += 1
        seen["inputs_not_cl"] += not args[0].is_contiguous(memory_format=torch.channels_last)

    def back(_module, _grad_in, grad_out):
        seen["grads"] += 1
        seen["grads_not_cl"] += not grad_out[0].is_contiguous(memory_format=torch.channels_last)

    norms = [m for m in model.modules() if isinstance(m, Norm)]
    handles = [m.register_forward_pre_hook(pre) for m in norms]
    handles += [m.register_full_backward_hook(back) for m in norms]
    opt = torch.optim.SGD(model.parameters(), lr=0.0)
    try:
        _resnet_step(model, opt, images, labels)
    finally:
        for h in handles:
            h.remove()
    return seen


def _resnet_loop(config):
    """The train loop of the ResNet phase, run by TorchTrainer in its worker
    actor: ResNet-50 (bf16 on f32 parameters, GroupNorm) on the worker's
    device, warm-up, timed and one profiled step on one synthetic batch.
    Each step reports its loss and wall time."""
    from ray_tpu_torch import train
    from ray_tpu_torch.models import ResNet50

    device = train.get_device()
    model = ResNet50(num_classes=1000, device=device, seed=0)
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    images, labels = _resnet_data(RESNET_B, RESNET_HW, device)
    step = train.prepare_step(lambda: _resnet_step(model, opt, images, labels))
    n = config["warmup"] + config["timed"]
    for i in range(n + 1):
        metrics = {"step": i, "warmup": i < config["warmup"]}
        if i == n:
            holder = {}
            metrics["profile"] = _profiled(lambda: holder.update(loss=step()), device)
            loss, wall = holder["loss"], metrics["profile"]["wall_s"]
            metrics["layout"] = _layout_probe(model, images, labels)
        else:
            t0 = time.perf_counter()
            loss = step().item()  # syncs
            wall = time.perf_counter() - t0
        metrics.update(loss=float(loss), step_s=wall)
        train.report(metrics)


def _attention_counters() -> dict:
    from ray_tpu_torch.ops.paged_flash import paged_flash_attention
    fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")

    return {
        "K1 paged_attention": paged_flash_attention,
        "K2 flash_fwd": fa.flash_attention_fwd,
        "K3 flash_bwd_fused": fa.flash_attention_bwd_fused,
        "K4 flash_bwd_dq": fa.flash_bwd_dq,
        "K5 flash_bwd_dkv": fa.flash_bwd_dkv,
        "K6 flash_fwd_packed": fa.flash_attention_packed_fwd,
        "K7 flash_bwd_packed": fa.flash_attention_packed_bwd,
    }


def _bare_resnet_steps(model, images, labels, steps) -> tuple:
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    losses, times = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(_resnet_step(model, opt, images, labels).item())
        times.append(time.perf_counter() - t0)
    if not all(np.isfinite(losses)):
        fail(f"[resnet] non-finite loss: {losses}")
    return losses, times


def _sgd_step_results(model, images, labels) -> tuple:
    """One step of `_resnet_step`'s loss and SGD on `model`'s device: the
    loss, every gradient and every parameter after the update, on the
    host."""
    dev = next(model.parameters()).device
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    loss = torch.nn.functional.cross_entropy(model(images.to(dev)).float(), labels.to(dev))
    loss.backward()
    grads = {n: p.grad.detach().cpu().clone() for n, p in model.named_parameters()}
    opt.step()
    return loss.item(), grads, {n: p.detach().cpu().clone() for n, p in model.named_parameters()}


def _compare_steps(got: tuple, want: tuple, limits: dict) -> tuple:
    """Two `_sgd_step_results` held against each other: the loss by its
    relative difference, each gradient and each parameter after the update
    by relative L2, against `limits` ("loss", "grad", "param"). Returns
    (the worst of each, failure messages)."""
    (lg, gg, pg), (lw, gw, pw) = got, want
    grad_rel = {n: _rel_l2(gg[n], gw[n]) for n in gw}
    param_rel = {n: _rel_l2(pg[n], pw[n]) for n in pw}
    worst_g = max(grad_rel, key=grad_rel.get)
    worst_p = max(param_rel, key=param_rel.get)
    res = {"loss_got": lg, "loss_want": lw, "loss_rel": abs(lg - lw) / abs(lw),
           "grad_rel_max": grad_rel[worst_g], "grad_worst": worst_g,
           "param_rel_max": param_rel[worst_p], "param_worst": worst_p,
           "limits": limits, "leaves": len(gw)}
    failures = []
    if not res["loss_rel"] <= limits["loss"]:
        failures.append(f"loss {lg} vs {lw}")
    if not grad_rel[worst_g] <= limits["grad"]:
        failures.append(f"gradient of {worst_g}: relative L2 {grad_rel[worst_g]}")
    if not param_rel[worst_p] <= limits["param"]:
        failures.append(f"parameter {worst_p} after the step: relative L2 {param_rel[worst_p]}")
    return res, failures


def _resnet_parity() -> dict:
    """One f32 step of ResNet-18 small_inputs on a batch of 4, on the card
    against the same step of the port on the CPU (same weights, with every
    norm scale drawn from U(0.5, 1.5) so that each block's convolutions get
    a gradient, and the same images): the loss, every gradient and every
    parameter after the update by relative L2, within
    RESNET_PARITY_LIMITS. cuDNN's f32 convolutions would default to TF32:
    it is off for this check."""
    from ray_tpu_torch.models import ResNet18
    from ray_tpu_torch.models.resnet import Norm

    gen = torch.Generator().manual_seed(7)
    cpu = ResNet18(num_classes=1000, dtype=torch.float32, small_inputs=True,
                   device="cpu", seed=1)
    with torch.no_grad():
        for m in cpu.modules():
            if isinstance(m, Norm):
                m.weight.copy_(torch.rand(m.weight.shape, generator=gen) + 0.5)
    card = ResNet18(num_classes=1000, dtype=torch.float32, small_inputs=True, seed=1)
    card.load_state_dict(cpu.state_dict())
    images = torch.randn((RESNET_PARITY_B, R18_HW, R18_HW, 3), generator=gen)
    labels = torch.randint(0, 1000, (RESNET_PARITY_B,), generator=gen)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        got = _sgd_step_results(card, images, labels)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    res, failures = _compare_steps(got, _sgd_step_results(cpu, images, labels),
                                   RESNET_PARITY_LIMITS)
    res = {"model": "resnet18 small_inputs f32, card (got) vs CPU (want)",
           "B": RESNET_PARITY_B, "HW": R18_HW, **res}
    log("[resnet] f32 card vs CPU: " + json.dumps(res))
    for msg in failures:
        fail(f"[resnet] f32 card vs CPU: {msg}")
    return res


def phase_resnet(device_info: dict) -> dict:
    """ResNet-50 at bench.py's shape through TorchTrainer.fit() on a worker
    actor on cuda:0 (RESNET_WARMUP + RESNET_TIMED steps and one profiled),
    with every attention kernel's counter set to 0 just before and read
    just after (none may launch); then norm="batch" for a few bare steps
    (running statistics finite and moved), ResNet-18 small_inputs at B256
    32x32, and the f32 card-against-CPU step."""
    import ray_tpu_torch
    from ray_tpu_torch.models import ResNet18, ResNet50
    from ray_tpu_torch.train import ScalingConfig, TorchTrainer

    t_phase = time.perf_counter()
    counters = _attention_counters()
    ray_tpu_torch.init()
    try:
        trainer = TorchTrainer(
            _resnet_loop,
            train_loop_config={"warmup": RESNET_WARMUP, "timed": RESNET_TIMED},
            scaling_config=ScalingConfig(num_workers=1),
        )
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for f in counters.values():
            f.launches = 0
        t0 = time.perf_counter()
        result = trainer.fit()
        fit_wall = time.perf_counter() - t0
        launches = {k: f.launches for k, f in counters.items()}
        peak_mib = torch.cuda.max_memory_allocated() / 2**20
    finally:
        ray_tpu_torch.shutdown()
    if result.error is not None:
        fail(f"[resnet] TorchTrainer.fit() failed: {result.error!r}")
    history = result.metrics_history
    losses = [m["loss"] for m in history]
    if len(losses) != RESNET_WARMUP + RESNET_TIMED + 1 or not all(np.isfinite(losses)):
        fail(f"[resnet] losses {losses}")
    if any(launches.values()):
        fail(f"[resnet] attention kernels launched on the ResNet path: {launches}")
    timed = [m["step_s"] for m in history if not m["warmup"] and "profile" not in m]
    step_p50 = statistics.median(timed)
    images_per_s = RESNET_B / step_p50
    tflops = images_per_s * RESNET_FLOP_PER_IMAGE / 1e12
    prof, layout = history[-1]["profile"], history[-1]["layout"]
    summary = {
        "model": "resnet50 bf16 (f32 params), GroupNorm, SGD(0.1, momentum 0.9)",
        "card": device_info["smi"], "B": RESNET_B, "HW": RESNET_HW,
        "steps": {"warmup": RESNET_WARMUP, "timed": RESNET_TIMED, "profiled": 1},
        "losses": losses, "step_s": [m["step_s"] for m in history],
        "step_p50_s": step_p50, "images_per_s": images_per_s,
        "train_tflops": tflops,
        "share_of_989_tflops": tflops * 1e12 / PEAK_FLOPS[torch.bfloat16],
        "fit_wall_s": fit_wall, "peak_alloc_mib": peak_mib,
        "profiled_step": prof, "norm_layout": layout, "attention_launches": launches,
    }
    log("[resnet] " + json.dumps(summary))

    # BatchNorm: a few bare steps; the running statistics move and stay finite.
    model = ResNet50(num_classes=1000, norm="batch", seed=0)
    images, labels = _resnet_data(RESNET_B, RESNET_HW, "cuda", seed=1)
    before = {n: b.clone() for n, b in model.named_buffers()}
    bn_losses, bn_times = _bare_resnet_steps(model, images, labels, RESNET_BATCHNORM_STEPS)
    after = dict(model.named_buffers())
    not_finite = [n for n, b in after.items() if not torch.isfinite(b).all()]
    unmoved = [n for n, b in after.items() if torch.equal(b, before[n])]
    if not_finite or unmoved:
        fail(f"[resnet] batch norm statistics: not finite {not_finite[:3]}, "
             f"unmoved {unmoved[:3]}")
    summary["batchnorm"] = {"steps": RESNET_BATCHNORM_STEPS, "losses": bn_losses,
                            "step_s": bn_times, "running_buffers": len(after),
                            "var_mean_after": statistics.fmean(
                                after[n].mean().item() for n in after if n.endswith("var"))}
    log("[resnet] batch norm: " + json.dumps(summary["batchnorm"]))
    del model, images, labels, before, after
    torch.cuda.empty_cache()

    # BASELINE.json's first configuration: ResNet-18 on 32x32 images.
    model = ResNet18(num_classes=1000, small_inputs=True, seed=0)
    images, labels = _resnet_data(R18_B, R18_HW, "cuda", seed=2)
    r18_losses, r18_times = _bare_resnet_steps(model, images, labels, R18_STEPS)
    r18_p50 = statistics.median(r18_times[1:])
    summary["resnet18"] = {"B": R18_B, "HW": R18_HW, "steps": R18_STEPS,
                           "losses": r18_losses, "step_s": r18_times,
                           "step_p50_s": r18_p50, "images_per_s": R18_B / r18_p50}
    log("[resnet] resnet18 small_inputs: " + json.dumps(summary["resnet18"]))
    del model, images, labels
    torch.cuda.empty_cache()

    summary["parity"] = _resnet_parity()
    summary["wall_s"] = time.perf_counter() - t_phase
    log(f"[resnet] phase wall {summary['wall_s']:.1f}s")
    return summary


# The MoE GPT: gpt2_125m with 8 experts in every second block (the
# reference's defaults: top-2, capacity factor 1.25).
MOE_EXPERTS = 8


def phase_moe(server: dict) -> dict:
    """gpt2_125m(num_experts=8): (a) TRAIN_STEPS fused_adamw steps at
    TRAIN_B x TRAIN_S through K6/K7 with the aux losses in the loss, the
    counters set to 0 just before and read just after; one more step
    profiled; the routing (aux sum, dropped share per MoE layer) of step 1's
    weights on its batch; f32 parity of one step against the plain
    attention path. (b) LLMServer in bf16 with the server phase's engine
    and 8 requests (K1, K2 counted), beside the dense server's numbers; f32
    kernels against the plain versions, token-identical. (c) the card
    memory left."""
    from ray_tpu_torch.llm import LLMServer
    from ray_tpu_torch.models import GPT, collect_moe_losses, gpt2_125m

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    mem0 = torch.cuda.memory_allocated()
    counters = _attention_counters()
    cfg = gpt2_125m(num_experts=MOE_EXPERTS)
    model = GPT(cfg, seed=0)
    params = dict(model.named_parameters())
    n_params = sum(p.numel() for p in params.values())
    n_experts = sum(p.numel() for n, p in params.items() if "moe_mlp.w_" in n)
    bf16 = sorted({n.split(".", 2)[2] for n, p in params.items() if p.dtype == torch.bfloat16})
    if bf16 != ["moe_mlp.w_in", "moe_mlp.w_out"]:
        fail(f"[moe] bf16 parameters {bf16}, not the experts alone")
    tokens = _tokens(TRAIN_B, TRAIN_S)
    with torch.no_grad():
        inter = model(tokens, return_aux=True)[1]  # the logits (786 MiB) not kept
    routing = {"aux_sum": collect_moe_losses(inter).item(),
               "dropped_share": {k: v["moe_stats"]["dropped_share"].item()
                                 for k, v in inter.items()}}
    del inter
    layers = cfg.num_layers

    for f in counters.values():
        f.launches = 0
    losses, times, (opt, state, params) = _run_steps(model, tokens, TRAIN_STEPS)
    launches = {k: f.launches for k, f in counters.items()}
    if not losses[-1] < losses[0]:
        fail(f"[moe] training loss did not fall on one batch: {losses}")
    for name in ("K6 flash_fwd_packed", "K7 flash_bwd_packed"):
        if launches[name] != layers * TRAIN_STEPS:
            fail(f"[moe] {name} launched {launches[name]} times, not {layers} x {TRAIN_STEPS}")
    step_p50 = statistics.median(times)

    def one_step():
        nonlocal state
        _, _, state = _train_step(model, opt, state, params, tokens)

    training = {
        "model": f"gpt2_125m num_experts={MOE_EXPERTS} bf16 (f32 params, bf16 experts)",
        "params": n_params, "expert_params": n_experts, "B": TRAIN_B, "S": TRAIN_S,
        "steps": TRAIN_STEPS, "losses": losses, "step_s": times, "step_p50_s": step_p50,
        "tokens_per_s": TRAIN_B * TRAIN_S / step_p50, "step1_routing": routing,
        "launches": {k: v for k, v in launches.items() if v},
        "profiled_step": _profiled(one_step),
    }
    log("[moe] train: " + json.dumps(training))
    del model, opt, state, params, tokens
    torch.cuda.empty_cache()
    training["parity"] = _f32_parity(
        gpt2_125m(num_experts=MOE_EXPERTS, dtype=torch.float32), PARITY_B, PARITY_S, tag="moe")

    # Serving: the server phase's engine and traffic.
    n_new = 32
    prompts = _prompts(np.random.RandomState(0))
    t0 = time.perf_counter()
    srv = LLMServer(cfg, _engine_config(), seed=0)
    up_s = time.perf_counter() - t0
    counters["K1 paged_attention"].launches = 0
    counters["K2 flash_fwd"].launches = 0
    results, ttft, wall = _concurrent(srv, prompts, n_new)
    serve_launches = {k: counters[k].launches for k in ("K1 paged_attention", "K2 flash_fwd")}
    m = srv.metrics()
    steps = [r["duration_s"] for r in srv.flight_record()["steps"]]
    _free(srv)
    del srv
    if any(r is None or len(r) != n_new for r in results):
        fail(f"[moe] not every request finished with {n_new} tokens")
    if m["prefix_cache_hit_tokens"] <= 0:
        fail("[moe] prefix cache never hit")
    for name, n in serve_launches.items():
        if n <= 0:
            fail(f"[moe] {name} was not launched on the MoE serving path")
    serving = {
        "requests": len(prompts), "tokens": n_new * len(prompts), "up_s": up_s,
        "wall_s": wall, "tokens_per_s": n_new * len(prompts) / wall,
        "ttft_p50_s": statistics.median(ttft), "step_p50_s": statistics.median(steps),
        "steps": m["steps"], "prefix_cache_hit_tokens": m["prefix_cache_hit_tokens"],
        "launches": serve_launches,
        "dense_server": {k: server[k] for k in ("tokens_per_s", "ttft_p50_s", "step_p50_s")},
    }
    log("[moe] serve: " + json.dumps(serving))
    serving["f32_batched_live_slots"] = _f32_token_identity(
        "moe", prompts, n_new, num_experts=MOE_EXPERTS)

    summary = {"train": training, "serve": serving, "before_mib": mem0 / 2**20,
               "left_allocated_mib": _settle(mem0, "moe"),
               "wall_s": time.perf_counter() - t_phase}
    log(f"[moe] {summary['left_allocated_mib']:.0f} MiB left allocated on the card "
        f"({summary['before_mib']:.0f} before the phase); "
        f"phase wall {summary['wall_s']:.1f}s")
    return summary


# Card memory that a teardown may leave above its figure before the run.
LEFT_LIMIT_MIB = 64


def _referrer_chain(obj, ignore: set, depth: int = 8) -> list:
    """Who keeps `obj` alive: from it towards a root, one referrer a level
    (skipping the ids in `ignore` and these helpers' own frames), each
    described by its type and, for a dict, its owner and the key that leads
    on; it ends at a module, a frame or after `depth` levels."""
    frame_type = type(sys._getframe())
    mine = ("_referrer_chain", "_card_holders")
    chain = []
    for _ in range(depth):
        refs = [r for r in gc.get_referrers(obj)
                if id(r) not in ignore and r is not chain
                and not (isinstance(r, frame_type) and r.f_code.co_name in mine)]
        if not refs:
            chain.append("(no referrer gc can see)")
            break
        ref = refs[0]
        ignore.update((id(ref), id(refs)))
        del refs
        if isinstance(ref, frame_type):
            chain.append(f"frame {ref.f_code.co_name} "
                         f"{ref.f_code.co_filename.split('/')[-1]}:{ref.f_lineno}")
            break
        if isinstance(ref, dict):
            key = "?"  # a loop, not a generator: that would hold `obj` in a cell
            for k, v in ref.items():
                if v is obj:
                    key = k
                    break
            owners = [o for o in gc.get_referrers(ref) if getattr(o, "__dict__", None) is ref]
            ignore.add(id(owners))
            owner = (f"{type(owners[0]).__qualname__} {getattr(owners[0], '__name__', '')}"
                     .strip() if owners else "dict")
            chain.append(f"{owner}[{str(key)[:40]}]")
            if owners and type(owners[0]).__name__ == "module":
                break
            if owners:
                ignore.add(id(ref))
                ref = owners[0]
        else:
            chain.append(type(ref).__qualname__)
        obj = ref
    return chain


def _card_holders(top: int = 5) -> dict:
    """What holds the card memory still allocated: the CUDA tensors gc can
    see (each storage once), their total against memory_allocated(), the
    largest `top` with a referrer chain each, and the live threads."""
    import warnings

    gc.collect()
    storages = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for obj in gc.get_objects():
            try:
                if isinstance(obj, torch.Tensor) and obj.is_cuda:
                    st = obj.untyped_storage()
                    storages.setdefault(st.data_ptr(), (st.nbytes(), obj))
            except Exception:  # noqa: BLE001 - half-built objects
                continue
        del obj
    entries = sorted(storages.values(), key=lambda e: -e[0])
    visible = sum(n for n, _ in entries)
    sizes = [n for n, _ in entries[:top]]
    tensors = [t for _, t in entries[:top]]
    del storages, entries
    ignore = {id(tensors)}
    largest = []
    for i in range(len(tensors)):
        largest.append({"mib": sizes[i] / 2**20, "shape": list(tensors[i].shape),
                        "dtype": str(tensors[i].dtype),
                        "held_by": _referrer_chain(tensors[i], ignore)})
    del tensors
    out = {
        "allocated_mib": torch.cuda.memory_allocated() / 2**20,
        "gc_visible_mib": visible / 2**20, "largest": largest,
        "threads": sorted(th.name for th in threading.enumerate()),
    }
    return out


def _settle(mem0: int, tag: str, deadline_s: float = 20.0) -> float:
    """Card memory (MiB) left allocated after a teardown, polled (gc,
    synchronize, cuBLAS's workspaces cleared, empty_cache) until it is
    within LEFT_LIMIT_MIB of `mem0` (the figure before the run) or
    `deadline_s` passed; beyond the limit it prints what holds the memory
    and fails. cuBLAS keeps a 32 MiB workspace for each (handle, stream)
    that any thread has run a product on, after the thread ends, until
    they are cleared: the library's cache, not the port's objects, so each
    reading clears them first and says how much that freed."""
    mib = 2**20
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    cleared = 0
    t0 = time.perf_counter()
    while True:
        gc.collect()
        torch.cuda.synchronize()
        if clear is not None:
            held = torch.cuda.memory_allocated()
            clear()
            cleared += held - torch.cuda.memory_allocated()
        torch.cuda.empty_cache()
        left = torch.cuda.memory_allocated()
        if left <= mem0 + LEFT_LIMIT_MIB * mib or time.perf_counter() - t0 > deadline_s:
            break
        time.sleep(0.25)
    log(f"[{tag}] card memory after the teardown: {left / mib:.0f} MiB allocated, "
        f"{mem0 / mib:.0f} before the run ({cleared / mib:.0f} MiB of cuBLAS "
        f"workspaces cleared first)")
    if left > mem0 + LEFT_LIMIT_MIB * mib:
        log(f"[{tag}] holders: " + json.dumps(_card_holders()))
        fail(f"[{tag}] {left / mib:.0f} MiB left allocated on the card after the "
             f"teardown, {(left - mem0) / mib:.0f} MiB above the {mem0 / mib:.0f} MiB "
             f"before the run (limit {LEFT_LIMIT_MIB} MiB)")
    return left / mib


# The tune phase: ASHA over 4 trials, PBT over 2, each trial a TorchTrainer
# fit of GPT-2 125M (attention_impl="auto", B8 S1024: K2 and K3) at half
# the card, one Tune iteration a step.
TUNE_MAX_T = 6
TUNE_ASHA_TRIALS, TUNE_ASHA_SEED = 4, 0  # seed 0 draws the two poorest lrs last
TUNE_PBT_LRS = (0.05, LR)  # Adam at 0.05 wrecks the model's loss; 3e-4 trains it
TUNE_PBT_INTERVAL = 2
TUNE_GPU = 0.5
_TUNE = {"lock": threading.Lock(), "live": 0, "max_live": 0, "steps": {}, "devices": set()}


def _tune_loop(config):
    """A Tune trial's train loop, run by TorchTrainer in its worker actor:
    _trainer_loop's model, batch and step at `config["lr"]`, one report a
    step (its loss, wall and the fit's id), up to `config["steps"]` steps.
    With `config["checkpoint_every"]`, every that many steps it reports a
    checkpoint of the parameters and both moments on the host, with their
    fingerprint (`_fingerprint`) taken on the card and an id. Resumed (a PBT
    exploit), it restores that state, checks it bit for bit against the
    checkpoint and reports, with its first step, the checkpoint's id and
    fingerprint beside the restored state's fingerprint on the card. While
    it runs it counts itself in _TUNE (trials at once, steps a fit)."""
    import uuid

    from ray_tpu_torch import train
    from ray_tpu_torch.air import Checkpoint
    from ray_tpu_torch.models.gpt import GPT, gpt2_125m
    from ray_tpu_torch.ops import FusedAdamWState, fused_adamw

    fit_id = uuid.uuid4().hex[:8]
    with _TUNE["lock"]:
        _TUNE["live"] += 1
        _TUNE["max_live"] = max(_TUNE["max_live"], _TUNE["live"])
        _TUNE["steps"][fit_id] = []
    try:
        device = train.get_device()
        _TUNE["devices"].add(str(device))
        model = GPT(gpt2_125m(attention_impl="auto"), device=device, seed=0)
        params = dict(model.named_parameters())
        opt = fused_adamw(config["lr"])
        state = opt.init(params)
        restored = None
        saved = train.get_checkpoint()
        if saved is not None:
            t_restore = time.perf_counter()
            saved = saved.to_dict()
            with torch.no_grad():
                for name, value in train.prepare_params(saved["params"]).items():
                    params[name].copy_(value)
            state = FusedAdamWState(count=saved["count"].clone(),
                                    mu=train.prepare_params(saved["mu"]),
                                    nu=train.prepare_params(saved["nu"]))
            live = {"params": params, "mu": state.mu, "nu": state.nu}
            restored = {
                "ckpt_id": saved["ckpt_id"], "from_lr": saved["lr"], "at_step": saved["step"],
                "bit_for_bit": all(torch.equal(live[part][k].detach().cpu(), saved[part][k])
                                   for part in live for k in params),
                "fingerprint_equal": _fingerprint(live) == saved["fingerprint"],
                "leaves": len(saved["fingerprint"]),
                "restore_s": time.perf_counter() - t_restore,
            }
            del saved
        gen = torch.Generator().manual_seed(0)
        tokens = train.prepare_batch(
            torch.randint(0, 50257, (TRAIN_B, TRAIN_S), generator=gen))
        opt_state = {"state": state}

        def step():
            loss, _, opt_state["state"] = _train_step(model, opt, opt_state["state"],
                                                      params, tokens)
            return loss

        step = train.prepare_step(step)
        start = int(state.count)
        every = config.get("checkpoint_every")
        for i in range(start, config["steps"]):
            t0 = time.perf_counter()
            loss = step().item()
            wall = time.perf_counter() - t0
            _TUNE["steps"][fit_id].append(wall)
            metrics = {"loss": loss, "step": i, "step_s": wall, "fit_id": fit_id,
                       "restored": restored if i == start else None}
            ckpt = None
            if every and (i + 1) % every == 0:
                t_ckpt = time.perf_counter()
                st = opt_state["state"]
                fingerprint = _fingerprint({"params": params, "mu": st.mu, "nu": st.nu})
                ckpt_id = uuid.uuid4().hex[:8]
                ckpt = Checkpoint.from_dict({
                    "params": {k: p.detach().cpu() for k, p in params.items()},
                    "mu": {k: m.cpu() for k, m in st.mu.items()},
                    "nu": {k: m.cpu() for k, m in st.nu.items()},
                    "count": st.count.clone(), "lr": config["lr"], "step": i,
                    "fingerprint": fingerprint, "ckpt_id": ckpt_id,
                })
                metrics.update(ckpt_id=ckpt_id, checkpoint_s=time.perf_counter() - t_ckpt)
            train.report(metrics, checkpoint=ckpt)
    finally:
        with _TUNE["lock"]:
            _TUNE["live"] -= 1


def _tune_run(name: str, tuner_kwargs: dict, trainer_config: dict, counters: dict) -> dict:
    """One Tuner.fit() over TorchTrainer(_tune_loop) trials: the launch
    counters set to 0 just before fit() and read just after, each trial's
    fit() walls (TorchTrainer.fit timed by its run name, the trial id), the
    controller's experiment-state saves timed, and the card memory before
    the fit and after it (polled, `_settle`)."""
    import tempfile

    from ray_tpu_torch import tune
    from ray_tpu_torch.train import CheckpointConfig, RunConfig, ScalingConfig, TorchTrainer
    from ray_tpu_torch.train.data_parallel_trainer import DataParallelTrainer
    from ray_tpu_torch.tune.execution.tune_controller import TuneController

    fit_walls, state_saves = {}, []
    saved = {"fit": DataParallelTrainer.fit, "save": TuneController._save_experiment_state}

    def timed_fit(self):
        t0 = time.perf_counter()
        try:
            return saved["fit"](self)
        finally:
            fit_walls.setdefault(self._run_name, []).append(time.perf_counter() - t0)

    def timed_save(self):
        t0 = time.perf_counter()
        saved["save"](self)
        state_saves.append(time.perf_counter() - t0)

    trainer = TorchTrainer(
        _tune_loop, train_loop_config=trainer_config,
        scaling_config=ScalingConfig(num_workers=1),
        run_config=RunConfig(checkpoint_config=CheckpointConfig(num_to_keep=1)))
    _TUNE.update(live=0, max_live=0, steps={}, devices=set())
    gc.collect()
    torch.cuda.empty_cache()
    mem0 = torch.cuda.memory_allocated()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tune_") as root:
        tuner = tune.Tuner(
            trainer, resources_per_trial={"CPU": 1, "GPU": TUNE_GPU},
            run_config=RunConfig(name=name, storage_path=root),
            **tuner_kwargs)
        DataParallelTrainer.fit, TuneController._save_experiment_state = timed_fit, timed_save
        try:
            for f in counters.values():
                f.launches = 0
            t0 = time.perf_counter()
            grid = tuner.fit()
            wall = time.perf_counter() - t0
            torch.cuda.synchronize()
            launches = {k: f.launches for k, f in counters.items()}
        finally:
            DataParallelTrainer.fit = saved["fit"]
            TuneController._save_experiment_state = saved["save"]
        trials = tuner._controller.trials
        pickled_mib = sum(
            os.path.getsize(os.path.join(dirpath, f)) for dirpath, _, files in os.walk(root)
            for f in files if f == "checkpoint.pkl") / 2**20
        del tuner
    for r in grid:
        if r.error:
            fail(f"[tune {name}] a trial failed: {r.error}")
    out = {"grid": grid, "trials": trials, "wall_s": wall, "launches": launches,
           "fit_walls": fit_walls, "state_saves_s": state_saves, "pickled_mib": pickled_mib,
           "max_live": _TUNE["max_live"], "devices": sorted(_TUNE["devices"]),
           "fit_steps": {k: list(v) for k, v in _TUNE["steps"].items()},
           "mem0_mib": mem0 / 2**20}
    del grid, trials
    out["left_mib"] = _settle(mem0, f"tune {name}")
    return out


def _tune_checks(name: str, run: dict, layers: int) -> dict:
    """What both runs must show: K2 and K3 launched 12 x the steps the
    trials' loops reported (every report call, the one a stop raised in
    included), K4-K7 none; at most two trials at once, all on cuda:0; the
    best trial's loss below its first step's. Returns the per-trial lines."""
    steps = sum(len(v) for v in run["fit_steps"].values())
    want = {k: (layers * steps if k in ("K2 flash_fwd", "K3 flash_bwd_fused") else 0)
            for k in run["launches"] if k != "K1 paged_attention"}
    got = {k: v for k, v in run["launches"].items() if k != "K1 paged_attention"}
    if got != want:
        fail(f"[tune {name}] launches {got}, not {want} ({steps} steps)")
    if run["max_live"] > 2 or run["devices"] != ["cuda:0"]:
        fail(f"[tune {name}] {run['max_live']} trials at once on {run['devices']}")
    lines = []
    for t in run["trials"]:
        seen = [r for r in t.results if "step" in r and not r.get("done")]
        fits = {r["fit_id"] for r in seen}
        step_s = sum(sum(run["fit_steps"].get(f, [])) for f in fits)
        lines.append({
            "trial": t.trial_id, "lr": t.config["train_loop_config"]["lr"],
            "iterations": t.iteration, "final_loss": seen[-1]["loss"] if seen else None,
            "first_loss": seen[0]["loss"] if seen else None, "status": t.status,
            "stopped_early": t.iteration < TUNE_MAX_T, "fits": len(fits),
            "steps_run": sum(len(run["fit_steps"].get(f, [])) for f in fits),
            "checkpoints_s": sum(r.get("checkpoint_s", 0.0) for r in seen),
            "fit_wall_s": sum(run["fit_walls"].get(t.trial_id, [])),
            "fit_minus_steps_s": sum(run["fit_walls"].get(t.trial_id, [])) - step_s,
        })
    best = min((ln for ln in lines if ln["final_loss"] is not None),
               key=lambda ln: ln["final_loss"])
    if not best["final_loss"] < best["first_loss"]:
        fail(f"[tune {name}] the best trial's loss did not fall: {best}")
    return {"trials": lines, "steps": steps}


def phase_tune() -> dict:
    """Tune over the trainer on the card: ray_tpu_torch.init with the card
    as the GPU resource, then (a) ASHA over 4 trials, lr loguniform
    (seeded), max_t 6, grace period 1, reduction factor 2; (b) PBT over 2
    trials, lr from a grid of one poor and one good value, perturbation
    interval 2 over 6 iterations, each trial reporting a host checkpoint of
    its parameters and both moments every 2 steps. Every trial is a
    TorchTrainer fit of GPT-2 125M at B8 S1024 taking half the card
    ({"CPU": 1, "GPU": 0.5}), so the card bounds the trials at once to two;
    max_failures 0. Each fit() is counted from 0 (K2 and K3 12 a step, K4-K7
    none); ASHA must stop a trial early, PBT must exploit, and the exploited
    trial must resume bit for bit from the source's checkpoint; the card
    memory after each fit() within LEFT_LIMIT_MIB of its figure before."""
    import ray_tpu_torch
    from ray_tpu_torch import tune
    from ray_tpu_torch.models.gpt import gpt2_125m
    from ray_tpu_torch.tune.schedulers import PopulationBasedTraining

    t_phase = time.perf_counter()
    counters = _attention_counters()
    layers = gpt2_125m().num_layers
    summary = {}
    ray_tpu_torch.init(num_cpus=8, num_gpus=1)
    try:
        asha = _tune_run("asha", dict(
            param_space={"train_loop_config": {"lr": tune.loguniform(1e-5, 1e-3)}},
            tune_config=tune.TuneConfig(
                metric="loss", mode="min", num_samples=TUNE_ASHA_TRIALS, seed=TUNE_ASHA_SEED,
                scheduler=tune.ASHAScheduler(max_t=TUNE_MAX_T, grace_period=1,
                                             reduction_factor=2))),
            {"steps": TUNE_MAX_T}, counters)
        checked = _tune_checks("asha", asha, layers)
        if not any(ln["stopped_early"] for ln in checked["trials"]):
            fail(f"[tune asha] no trial stopped before max_t: {checked['trials']}")
        for ln in checked["trials"]:
            log("[tune] asha trial " + json.dumps(ln))
        summary["asha"] = {**checked, **{k: asha[k] for k in (
            "wall_s", "launches", "max_live", "devices", "state_saves_s", "pickled_mib",
            "mem0_mib", "left_mib")}}
        del asha

        pbt = PopulationBasedTraining(
            metric="loss", mode="min", perturbation_interval=TUNE_PBT_INTERVAL,
            quantile_fraction=0.5, resample_probability=0.0, seed=0,
            hyperparam_mutations={"train_loop_config": [{"lr": lr} for lr in TUNE_PBT_LRS]})
        run = _tune_run("pbt", dict(
            param_space={"train_loop_config": tune.grid_search(
                [{"lr": lr} for lr in TUNE_PBT_LRS])},
            tune_config=tune.TuneConfig(metric="loss", mode="min", scheduler=pbt)),
            {"steps": TUNE_MAX_T, "checkpoint_every": TUNE_PBT_INTERVAL}, counters)
        checked = _tune_checks("pbt", run, layers)
        owners = {r["ckpt_id"]: (t.trial_id, r["step"]) for t in run["trials"]
                  for r in t.results if r.get("ckpt_id")}
        exploits = []
        for t in run["trials"]:
            for r in t.results:
                restored = r.get("restored")
                if not restored:
                    continue
                source = owners.get(restored["ckpt_id"], ("?", None))
                exploits.append({"trial": t.trial_id, "source": source[0],
                                 "source_step": restored["at_step"], "resumed_step": r["step"],
                                 "new_lr": t.config["train_loop_config"]["lr"], **restored})
        for ex in exploits:
            log("[tune] pbt exploit " + json.dumps(ex))
        if not exploits:
            fail("[tune pbt] PBT exploited no trial")
        for ex in exploits:
            if not (ex["bit_for_bit"] and ex["fingerprint_equal"]) or ex["source"] in (
                    "?", ex["trial"]):
                fail(f"[tune pbt] the exploited trial did not resume bit for bit from "
                     f"another trial's checkpoint: {ex}")
        for ln in checked["trials"]:
            log("[tune] pbt trial " + json.dumps(ln))
        summary["pbt"] = {**checked, "exploits": exploits, **{k: run[k] for k in (
            "wall_s", "launches", "max_live", "devices", "state_saves_s", "pickled_mib",
            "mem0_mib", "left_mib")}}
        del run
    finally:
        ray_tpu_torch.shutdown()
    summary["wall_s"] = time.perf_counter() - t_phase
    for name in ("asha", "pbt"):
        s = summary[name]
        log(f"[tune] {name}: fit() {s['wall_s']:.1f}s, {s['steps']} steps, "
            f"{s['max_live']} trials at once on {s['devices']}, experiment state saved "
            f"{len(s['state_saves_s'])}x in {sum(s['state_saves_s']):.2f}s "
            f"({s['pickled_mib']:.0f} MiB of checkpoints pickled), card memory "
            f"{s['mem0_mib']:.0f} MiB before and {s['left_mib']:.0f} MiB after")
    log(f"[tune] phase wall {summary['wall_s']:.1f}s")
    return summary


# The rllib phase: RLlib's PPO and IMPALA at bench.py's accelerator shapes
# (`bench_ppo`, `bench_impala`, branch `on_tpu`), the learner on cuda:0, the
# envs and the numpy policy forward on the host.
RLLIB_PPO = dict(envs=128, frag=64, train_batch=8192, minibatch=256, epochs=4, timed=5)
RLLIB_IMPALA = dict(envs=256, frag=64, train_batch=4096, timed=10)
RLLIB_SEED = 0
# Card against CPU in f32 (TF32 off): each tensor's change over one update
# within 1e-4 relative L2 and every element within 0.05 x lr, the metrics
# within 1e-4. cuBLAS and the CPU's BLAS sum float32 products in different
# orders (a few ulps a product); Adam turns a gradient element near 0 into a
# step of up to lr either way, so elements are held to a share of lr, and a
# step of the wrong sign or size (~lr) or a wrong bias correction fails. The
# metrics' relative error has a floor of 0.01 under its denominator.
RLLIB_PARITY = dict(rel_l2=1e-4, lr_share=0.05, metrics_rtol=1e-4)


def _rllib_ppo_config(**learners):
    from ray_tpu_torch.rllib.algorithms.ppo import PPOConfig

    p = RLLIB_PPO
    return (PPOConfig().environment("CartPole-v1")
            .env_runners(num_env_runners=1, num_envs_per_env_runner=p["envs"],
                         rollout_fragment_length=p["frag"])
            .training(train_batch_size=p["train_batch"], minibatch_size=p["minibatch"],
                      num_epochs=p["epochs"])
            .learners(**learners).debugging(seed=RLLIB_SEED))


def _timed_updates(learner, last_batch=None) -> list:
    """Wrap the learner's update (an instance attribute) to record each
    call's wall (and, given `last_batch`, keep the batch of the last call
    there); an update ends by copying its metrics to the host, so the wall
    covers its device work."""
    walls = []
    inner = learner.update

    def update(batch):
        if last_batch is not None:
            last_batch[:] = [batch]
        t0 = time.perf_counter()
        out = inner(batch)
        walls.append(time.perf_counter() - t0)
        return out

    learner.update = update
    return walls


@contextlib.contextmanager
def _timed_waits(record: list):
    """Record the seconds each ray_tpu_torch.wait() blocks: PPO's training
    step waits there for its runners' fragments."""
    import ray_tpu_torch

    inner = ray_tpu_torch.wait

    def wait(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return inner(*args, **kwargs)
        finally:
            record.append(time.perf_counter() - t0)

    ray_tpu_torch.wait = wait
    try:
        yield
    finally:
        ray_tpu_torch.wait = inner


def _bare_update(learner, batch) -> dict:
    """Two more PPO updates with the runners idle: the first timed alone,
    its wall beside the timed iterations' (there the runner's sampling
    thread shares the interpreter); the second under torch.profiler with
    CPU and CUDA activity for its kernel launches and the five host ops
    with the most self CPU time (the profiler slows the host, so that
    update's wall is not reported)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    learner.update(batch)
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        learner.update(batch)
    events = prof.key_averages()
    top = sorted(events, key=lambda e: -e.self_cpu_time_total)[:5]
    return {"wall_s": wall,
            "launches": sum(e.count for e in events if e.key.startswith("cudaLaunch")),
            "top_cpu_ops_ms": [[e.key[:80], e.self_cpu_time_total / 1e3, e.count] for e in top]}


def _finite_losses(results: list, tag: str) -> None:
    for r in results:
        for k in ("total_loss", "policy_loss", "vf_loss"):
            if not np.isfinite(r.get(k, float("nan"))):
                fail(f"[{tag}] {k} is not finite: {r.get(k)} (learner_error "
                     f"{r.get('learner_error')})")


def _host_state(state: dict) -> dict:
    """A learner state's tensors, flattened: weights, mu and nu by name."""
    out = {f"weights/{k}": v for k, v in state["weights"].items()}
    for moment in ("mu", "nu"):
        out.update({f"{moment}/{k}": v for k, v in state["opt_state"][moment].items()})
    return out


def _rllib_ppo(card: str, counters: dict) -> dict:
    """(a) PPO at bench_ppo's shape: 1 warm-up and RLLIB_PPO["timed"] timed
    train() calls and one under torch.profiler, the counters set to 0 just
    before the first and read just after the last; then (e) a checkpoint
    round trip on the same algorithm."""
    import ray_tpu_torch

    algo = _rllib_ppo_config().build()
    learner = algo.learner_group.local_learner
    cuda0 = torch.device("cuda", 0)
    placed = {
        "params": sorted({str(p.device) for p in learner.module.params.values()}),
        "adam": sorted({str(t.device) for m in ("mu", "nu")
                        for t in learner._opt_state[m].values()}),
        "local_runner": str(algo.env_runner_group.local_runner.module.device),
        "remote_runner": ray_tpu_torch.get(
            algo.env_runner_group.remote_runners()[1].module_device.remote()),
    }
    if placed["params"] != [str(cuda0)] or placed["adam"] != [str(cuda0)]:
        fail(f"[rllib ppo] the learner's parameters or Adam state are not on cuda:0: {placed}")
    if placed["local_runner"] != "cpu" or placed["remote_runner"] != "cpu":
        fail(f"[rllib ppo] a runner's module is not on the CPU: {placed}")
    last_batch: list = []
    walls = _timed_updates(learner, last_batch)
    waits: list = []
    for f in counters.values():
        f.launches = 0
    results, iters = [], []
    with _timed_waits(waits):
        results.append(algo.train())  # warm-up, as bench_ppo
        steps0 = algo._env_steps_total
        t0 = time.perf_counter()
        for _ in range(RLLIB_PPO["timed"]):
            n_waits, t_iter = len(waits), time.perf_counter()
            results.append(algo.train())
            iters.append({"wall_s": time.perf_counter() - t_iter, "update_s": walls[-1],
                          "sampling_wait_s": sum(waits[n_waits:])})
        dt = time.perf_counter() - t0
        env_steps_s = (algo._env_steps_total - steps0) / dt
        n_waits = len(waits)
        profiled = _profiled(lambda: results.append(algo.train()))
        profiled.update(update_s=walls[-1], sampling_wait_s=sum(waits[n_waits:]))
    launches = {k: f.launches for k, f in counters.items()}
    # The runner's fragment for the next iteration ends before the bare update.
    pending = list(algo._inflight_samples.values())
    ray_tpu_torch.wait(pending, num_returns=len(pending), timeout=60.0)
    bare = _bare_update(learner, last_batch[0])
    _finite_losses(results, "rllib ppo")
    first, last = (r.get("episode_return_mean", float("nan")) for r in (results[0], results[-1]))
    if not last > first:
        fail(f"[rllib ppo] episode_return_mean did not rise: first {first}, last {last}")
    out = {
        "card": card, "env_steps_s": env_steps_s, "timed_s": dt,
        "update_s": [i["update_s"] for i in iters],
        "iteration_s": [i["wall_s"] for i in iters],
        "sampling_wait_s": [i["sampling_wait_s"] for i in iters],
        "learner_steps_per_update": RLLIB_PPO["epochs"] * (
            RLLIB_PPO["train_batch"] // RLLIB_PPO["minibatch"]),
        "profiled": profiled, "bare_update": bare, "launches": launches, "placed": placed,
        "episode_return_mean": [r.get("episode_return_mean") for r in results],
        "last": {k: results[-1][k] for k in ("total_loss", "policy_loss", "vf_loss",
                                            "entropy", "mean_kl", "grad_norm")},
    }

    # (e) save()/restore() bit for bit: the host state saved, one more
    # iteration, the restore, then the learner's tensors on the card against
    # the saved host copies.
    ckpt = algo.save()
    saved = _host_state(algo.learner_group.get_state())
    count = learner._opt_state["count"]
    algo.train()
    moved = not all(torch.equal(v, saved[k])
                    for k, v in _host_state(algo.learner_group.get_state()).items())
    algo.restore(ckpt)
    live = {f"weights/{k}": p.detach() for k, p in learner.module.params.items()}
    for moment in ("mu", "nu"):
        live.update({f"{moment}/{k}": t for k, t in learner._opt_state[moment].items()})
    equal = all(torch.equal(t, saved[k].to(t.device)) for k, t in live.items())
    out["checkpoint"] = {"tensors": len(live), "moved_by_the_next_iteration": moved,
                         "restored_bit_for_bit": equal,
                         "count": [count, learner._opt_state["count"]]}
    if not (moved and equal and count == learner._opt_state["count"]):
        fail(f"[rllib ppo] the checkpoint did not round-trip bit for bit: {out['checkpoint']}")
    algo.stop()
    del algo, learner, ckpt, saved, live, last_batch
    return out


def _rllib_impala(card: str, counters: dict) -> dict:
    """(b) IMPALA at bench_impala's shape: 1 + RLLIB_IMPALA["timed"] train()
    calls, the counters set to 0 just before and read just after."""
    from ray_tpu_torch.rllib.algorithms.impala import IMPALAConfig

    p = RLLIB_IMPALA
    algo = (IMPALAConfig().environment("MinAtar-Breakout")
            .env_runners(num_env_runners=1, num_envs_per_env_runner=p["envs"],
                         rollout_fragment_length=p["frag"])
            .training(train_batch_size=p["train_batch"])
            .debugging(seed=RLLIB_SEED)).build()
    walls = _timed_updates(algo.learner_group.local_learner)
    for f in counters.values():
        f.launches = 0
    results = [algo.train()]  # pipeline fill, as bench_impala
    steps0, updates0 = algo._env_steps_total, results[0]["num_learner_updates"]
    t0 = time.perf_counter()
    for _ in range(p["timed"]):
        results.append(algo.train())
    dt = time.perf_counter() - t0
    launches = {k: f.launches for k, f in counters.items()}
    env_steps_s = (algo._env_steps_total - steps0) / dt
    errors = [r["learner_error"] for r in results if "learner_error" in r]
    if errors or results[-1]["num_learner_updates"] <= 0:
        fail(f"[rllib impala] learner updates {results[-1]['num_learner_updates']}, "
             f"errors {errors}")
    _finite_losses(results, "rllib impala")
    out = {
        "card": card, "env_steps_s": env_steps_s, "timed_s": dt,
        "updates_per_iteration": (results[-1]["num_learner_updates"] - updates0) / p["timed"],
        "queue_size": [r["learner_queue_size"] for r in results],
        "batches_enqueued": [r["num_batches_enqueued"] for r in results],
        "update_s": walls, "launches": launches,
        "episode_return_mean": [r.get("episode_return_mean") for r in results],
        "last": {k: results[-1][k] for k in ("total_loss", "policy_loss", "vf_loss",
                                            "entropy", "mean_rho", "grad_norm")},
    }
    algo.stop()
    del algo
    return out


def _rllib_parity(card: str) -> dict:
    """(c) One PPO update (2 minibatches) and one IMPALA update on the same
    batch from the same state, on cuda:0 and on the CPU, in f32: each
    tensor's change and the metrics held by RLLIB_PARITY. Both learners
    draw their epoch orders from the same seeded host generator."""
    from ray_tpu_torch.rllib.algorithms.impala import IMPALAConfig, IMPALALearner
    from ray_tpu_torch.rllib.algorithms.ppo import PPOConfig, PPOLearner
    from ray_tpu_torch.rllib.core.rl_module import RLModuleSpec
    from ray_tpu_torch.rllib.evaluation.env_runner import EnvRunner

    out = {}
    cases = (("ppo", PPOConfig, PPOLearner, "CartPole-v1", 64, 32, dict(minibatch_size=1024)),
             ("impala", IMPALAConfig, IMPALALearner, "MinAtar-Breakout", 32, 64, {}))
    for name, cfg_cls, learner_cls, env, envs, frag, training in cases:
        cfg = (cfg_cls().environment(env)
               .env_runners(num_envs_per_env_runner=envs, rollout_fragment_length=frag)
               .training(num_epochs=1, **training).debugging(seed=RLLIB_SEED))
        runner = EnvRunner(cfg)
        batch = runner.sample()
        obs_space, act_space = runner.spaces()
        spec = RLModuleSpec(observation_space=obs_space, action_space=act_space,
                            seed=RLLIB_SEED)
        learners = {d: learner_cls(spec, cfg, device=d) for d in ("cuda", "cpu")}
        for learner in learners.values():
            learner.build()
        learners["cuda"].set_weights(learners["cpu"].get_weights())
        before = learners["cpu"].get_weights()
        metrics = {d: learner.update(batch) for d, learner in learners.items()}
        after = {d: learner.get_weights() for d, learner in learners.items()}
        lr = learners["cpu"].optimizer.lr
        worst = {"rel_l2": 0.0, "lr_share": 0.0, "metrics_rel": 0.0}
        for k, b in before.items():
            d_card, d_cpu = after["cuda"][k] - b, after["cpu"][k] - b
            worst["rel_l2"] = max(worst["rel_l2"], float(
                torch.linalg.vector_norm(d_card - d_cpu) / torch.linalg.vector_norm(d_cpu)))
            worst["lr_share"] = max(worst["lr_share"],
                                    float((d_card - d_cpu).abs().max()) / lr)
        for k, v in metrics["cpu"].items():
            # Relative, with a floor of 0.01: policy_loss is ~0 at the first
            # step (standardised advantages at ratio 1).
            worst["metrics_rel"] = max(worst["metrics_rel"],
                                       abs(metrics["cuda"][k] - v) / max(abs(v), 1e-2))
        out[name] = {"rows": batch.count, "steps": learners["cpu"]._opt_state["count"],
                     "lr": lr, **worst, "grad_norm": metrics["cuda"]["grad_norm"]}
        log(f"[rllib parity] ({card}) {name}: " + json.dumps(out[name]))
        if (worst["rel_l2"] > RLLIB_PARITY["rel_l2"]
                or worst["lr_share"] > RLLIB_PARITY["lr_share"]
                or worst["metrics_rel"] > RLLIB_PARITY["metrics_rtol"]):
            fail(f"[rllib parity] {name}: card against CPU beyond {RLLIB_PARITY}: {out[name]}")
        del learners, before, after
    return out


def _rllib_cuda_runner() -> dict:
    """(f) An env runner with sample_device="cuda": its module on the card,
    the torch forward and a CUDA generator sampling each step's actions;
    one PPO fragment of CartPole-v1 (128 envs x 64 steps), its columns
    finite and its GAE present."""
    from ray_tpu_torch.rllib.algorithms.ppo import PPOConfig
    from ray_tpu_torch.rllib.evaluation.env_runner import EnvRunner
    from ray_tpu_torch.rllib.policy.sample_batch import SampleBatch

    runner = EnvRunner(PPOConfig().environment("CartPole-v1")
                       .env_runners(num_envs_per_env_runner=RLLIB_PPO["envs"],
                                    rollout_fragment_length=RLLIB_PPO["frag"],
                                    sample_device="cuda").debugging(seed=RLLIB_SEED))
    t0 = time.perf_counter()
    batch = runner.sample()
    wall = time.perf_counter() - t0
    floats = [k for k, v in batch.items() if np.asarray(v).dtype.kind == "f"]
    out = {"module": runner.module_device(), "numpy_path": runner._np_explore is not None,
           "rows": batch.count, "fragment_s": wall,
           "finite": all(np.isfinite(np.asarray(batch[k])).all() for k in floats),
           "gae": SampleBatch.ADVANTAGES in batch}
    if (out["module"] != "cuda:0" or out["numpy_path"] or not out["finite"]
            or not out["gae"] or out["rows"] != RLLIB_PPO["envs"] * RLLIB_PPO["frag"]):
        fail(f"[rllib cuda runner] {out}")
    runner.stop()
    del runner, batch
    return out


def _rllib_remote_learners() -> dict:
    """(d) Two learner actors at num_gpus_per_learner=0.5 on the card: one
    PPO iteration (gradients of two shards averaged on the host and applied
    on both); both learners' weights equal bit for bit afterwards."""
    import ray_tpu_torch

    algo = (_rllib_ppo_config(num_learners=2, num_gpus_per_learner=0.5)
            .training(train_batch_size=2048)).build()
    t0 = time.perf_counter()
    result = algo.train()
    wall = time.perf_counter() - t0
    weights = [ray_tpu_torch.get(w.get_weights.remote()) for w in algo.learner_group._workers]
    equal = all(torch.equal(weights[0][k], weights[1][k]) for k in weights[0])
    states = algo.learner_group.foreach_learner("get_state")
    out = {"learners": len(weights), "bit_for_bit": equal, "iteration_s": wall,
           "adam_counts": [s["opt_state"]["count"] for s in states],
           "total_loss": result["total_loss"]}
    if not equal or not np.isfinite(result["total_loss"]):
        fail(f"[rllib remote learners] {out}")
    algo.stop()
    del algo, weights, states
    return out


def _rllib_log(name: str, card: str, part: dict) -> None:
    """The `[rllib]` lines of one part of the phase, printed as it ends."""
    if name in ("ppo", "impala"):
        launched = {k: n for k, n in part["launches"].items() if n}
        if launched:
            fail(f"[rllib {name}] attention kernels launched on RLlib's path: {launched}")
    if name == "ppo":
        prof = part["profiled"]
        log(f"[rllib] ({card}) ppo CartPole-v1: {part['env_steps_s']:.1f} env-steps/s "
            f"(bench_ppo's count: 5 iterations after 1 warm-up, {part['timed_s']:.2f}s); "
            f"update p50 {statistics.median(part['update_s']) * 1e3:.1f} ms "
            f"({part['learner_steps_per_update']} minibatch steps), iteration p50 "
            f"{statistics.median(part['iteration_s']) * 1e3:.1f} ms, sampling wait p50 "
            f"{statistics.median(part['sampling_wait_s']) * 1e3:.1f} ms an iteration")
        log(f"[rllib] ({card}) ppo profiled iteration: wall {prof['wall_s'] * 1e3:.1f} ms, "
            f"update {prof['update_s'] * 1e3:.1f} ms, card busy "
            f"{prof['device_busy_s'] * 1e3:.1f} ms ({prof['device_busy_share'] * 100:.1f}%), "
            f"sampling wait {prof['sampling_wait_s'] * 1e3:.1f} ms; top kernels "
            f"{json.dumps(prof['top_kernels_ms'])}")
        bare = part["bare_update"]
        log(f"[rllib] ({card}) ppo update with the runners idle: wall "
            f"{bare['wall_s'] * 1e3:.1f} ms; under the profiler {bare['launches']} kernel "
            f"launches, top host ops (self ms, calls) {json.dumps(bare['top_cpu_ops_ms'])}")
        log(f"[rllib] ({card}) ppo episode_return_mean by iteration "
            f"{json.dumps(part['episode_return_mean'])}; last losses {json.dumps(part['last'])}; "
            f"placed {json.dumps(part['placed'])}; checkpoint {json.dumps(part['checkpoint'])}")
    elif name == "impala":
        log(f"[rllib] ({card}) impala MinAtar-Breakout: {part['env_steps_s']:.1f} env-steps/s "
            f"(10 iterations after 1, {part['timed_s']:.2f}s); "
            f"{part['updates_per_iteration']:.2f} learner updates an iteration, update p50 "
            f"{statistics.median(part['update_s']) * 1e3:.1f} ms; queue occupancy "
            f"{json.dumps(part['queue_size'])}; batches enqueued "
            f"{json.dumps(part['batches_enqueued'])}; last losses {json.dumps(part['last'])}")
    elif name in ("remote_learners", "cuda_runner"):
        log(f"[rllib] ({card}) {name}: {json.dumps(part)}")


def phase_rllib(device_info: dict) -> dict:
    """RLlib's PPO and IMPALA on the port: the learner on cuda:0, the envs
    and the numpy policy forward on the host, at bench.py's accelerator
    shapes: (a) PPO on CartPole-v1 (1 runner x 128 envs, fragment 64, batch
    8192, minibatch 256, 4 epochs: 1 warm-up, 5 timed and 1 profiled
    iterations) and (e) its checkpoint round trip, (b) IMPALA on
    MinAtar-Breakout (1 runner x 256 envs, fragment 64, batch 4096; 1 + 10
    iterations), (c) f32 card against CPU of one update of each, (d) two
    learner actors at half the card each, (f) a runner sampling through its
    torch forward on the card. No attention kernel may launch on
    (a) or (b): RLlib's networks are dense products. The card memory after
    each algorithm's cleanup() within LEFT_LIMIT_MIB of its figure before."""
    import ray_tpu_torch

    t_phase = time.perf_counter()
    card = device_info["smi"]
    counters = _attention_counters()
    summary = {}
    ray_tpu_torch.init(num_cpus=8, num_gpus=1)
    try:
        for name, run in (("ppo", lambda: _rllib_ppo(card, counters)),
                          ("impala", lambda: _rllib_impala(card, counters)),
                          ("parity", lambda: _rllib_parity(card)),
                          ("remote_learners", _rllib_remote_learners),
                          ("cuda_runner", _rllib_cuda_runner)):
            mem0 = torch.cuda.memory_allocated()
            summary[name] = run()
            summary[name]["left_mib"] = _settle(mem0, f"rllib {name}")
            _rllib_log(name, card, summary[name])
    finally:
        ray_tpu_torch.shutdown()
    summary["wall_s"] = time.perf_counter() - t_phase
    log(f"[rllib] phase wall {summary['wall_s']:.1f}s")
    return summary


# The rllib_algos phase: the rest of RLlib on the port, each learner on
# cuda:0 and the envs, replay and offline files on the host. DQN, SAC and
# TD3 at their configs' defaults; APPO at bench_impala's shape and A2C at
# bench_ppo's (envs, fragment, batch).
ALGOS_DQN_STEPS = 3000  # env steps a DQN run (1,000 before learning)
ALGOS_SAC_UPDATES = 500  # updates a SAC / TD3 run (after 1,000 env steps)
ALGOS_APEX_ITERS = 40
ALGOS_ON_POLICY_ITERS = 3  # timed after 1 warm-up (APPO: pipeline fill)
ALGOS_BC_ITERS = 40
ALGOS_CQL_ITERS = 20
ALGOS_PPO_LOG = dict(envs=32, frag=64, iters=8)  # PPO whose rollouts BC clones


def _on_cuda0(learner) -> dict:
    """Where a learner's parameters, Adam moments and extra state live."""
    extra = []

    def walk(tree):
        if isinstance(tree, torch.Tensor):
            extra.append(str(tree.device))
        elif isinstance(tree, dict):
            for v in tree.values():
                walk(v)

    walk(learner.extra_train_state)
    return {"params": sorted({str(p.device) for p in learner.module.params.values()}),
            "adam": sorted({str(t.device) for m in ("mu", "nu")
                            for t in learner._opt_state[m].values()}),
            "extra": sorted(set(extra))}


def _check_placed(tag: str, learner) -> dict:
    placed = _on_cuda0(learner)
    if any(v and v != ["cuda:0"] for v in placed.values()) or not placed["params"]:
        fail(f"[{tag}] the learner's state is not all on cuda:0: {placed}")
    return placed


def _launches_per_update(learner, batch) -> int:
    """Kernel launches (cudaLaunchKernel and friends) of one update, counted
    by torch.profiler's host events."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        learner.update(batch)
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages() if e.key.startswith("cudaLaunch"))


def _finite(results: list, keys, tag: str) -> None:
    for r in results:
        for k in keys:
            if k in r and not np.isfinite(r[k]):
                fail(f"[{tag}] {k} is not finite: {r[k]}")


def _zero(counters: dict) -> None:
    for f in counters.values():
        f.launches = 0


def _read(counters: dict) -> dict:
    return {k: f.launches for k, f in counters.items()}


def _train_loop(algo, tag: str, counters: dict, until) -> dict:
    """train() until `until(algo, results)`, the learner's updates timed,
    the attention counters set to 0 just before and read just after; then
    one more iteration under torch.profiler (the card's busy share) and the
    launches of one bare update on the last batch."""
    learner = algo.learner_group.local_learner
    last_batch: list = []
    walls = _timed_updates(learner, last_batch)
    results = []
    _zero(counters)
    t0 = time.perf_counter()
    while not until(algo, results):
        results.append(algo.train())
    wall = time.perf_counter() - t0
    launches = _read(counters)
    steps, updates = algo._env_steps_total, list(walls)
    if not updates:
        fail(f"[{tag}] the learner took no update")
    iterations = len(results)
    profiled = _profiled(lambda: results.append(algo.train()))
    return {"iterations": iterations, "env_steps": steps, "wall_s": wall,
            "env_steps_s": steps / wall, "updates": len(updates),
            "update_p50_ms": statistics.median(updates) * 1e3,
            "update_p90_ms": float(np.percentile(updates, 90)) * 1e3,
            "launches_per_update": _launches_per_update(learner, last_batch[0]),
            "busy_share": profiled["device_busy_share"],
            "profiled_wall_ms": profiled["wall_s"] * 1e3, "launches": launches,
            "placed": _check_placed(tag, learner), "results": results}


def _algos_dqn(counters: dict, prioritized: bool) -> dict:
    """(a) DQN on CartPole-v1 at DQNConfig's defaults, uniform replay or
    n_step=3 with prioritized replay, to ALGOS_DQN_STEPS env steps."""
    from ray_tpu_torch.rllib.algorithms.dqn import DQNConfig
    from ray_tpu_torch.rllib.utils.replay_buffers import PrioritizedReplayBuffer

    cfg = DQNConfig().environment("CartPole-v1").debugging(seed=RLLIB_SEED)
    if prioritized:
        cfg = cfg.training(n_step=3, replay_buffer_config=dict(
            cfg.replay_buffer_config, type="PrioritizedReplayBuffer"))
    algo = cfg.build()
    tag = "rllib_algos dqn" + (" prioritized" if prioritized else "")
    out = _train_loop(algo, tag, counters,
                      lambda a, r: a._env_steps_total >= ALGOS_DQN_STEPS)
    _finite(out["results"], ("total_loss", "td_error_abs", "qf_mean"), tag)
    buf = algo.replay_buffer
    out["buffer"] = type(buf).__name__
    if prioritized:
        pri = buf._priorities[: len(buf)]
        out["priorities"] = {"max_priority": buf._max_priority, "distinct": int(np.unique(pri).size),
                             "min": float(pri.min()), "max": float(pri.max())}
        if not (isinstance(buf, PrioritizedReplayBuffer) and buf._max_priority > 1.0
                and out["priorities"]["distinct"] > 100):
            fail(f"[{tag}] the TD errors did not move the priorities: {out['priorities']}")
    last = out.pop("results")[-1]
    out["last"] = {k: last[k] for k in ("total_loss", "td_error_abs", "qf_mean", "grad_norm")}
    out["episode_return_mean"] = last.get("episode_return_mean")
    algo.stop()
    del algo, buf
    return out


def _algos_apex(counters: dict) -> dict:
    """(b) Ape-X on CartPole: 2 replay shards, 2 env runners, learning from
    256 env steps, ALGOS_APEX_ITERS iterations: every shard fills, the TD
    errors come back as priorities, and stop() leaves no shard actor."""
    from ray_tpu_torch.rllib.algorithms.apex_dqn import ApexDQNConfig

    cfg = (ApexDQNConfig().environment("CartPole-v1").env_runners(num_env_runners=2)
           .training(num_steps_sampled_before_learning_starts=256).debugging(seed=RLLIB_SEED))
    algo = cfg.build()
    shards = list(algo.replay_shards)
    names = {f"actor-{s._actor_id.hex()[:8]}" for s in shards}
    _zero(counters)
    t0 = time.perf_counter()
    results = [algo.train() for _ in range(ALGOS_APEX_ITERS)]
    wall = time.perf_counter() - t0
    launches = _read(counters)
    sizes = [_get(s.size.remote()) for s in shards]
    weights = [_get(s.sample.remote(32))["weights"] for s in shards]
    placed = _check_placed("rllib_algos apex", algo.learner_group.local_learner)
    updates = sum(1 for r in results if "td_error_abs" in r)
    algo.stop()
    deadline = time.monotonic() + 10.0
    while time.monotonic() < deadline and names & {t.name for t in threading.enumerate()}:
        time.sleep(0.05)
    alive = sorted(names & {t.name for t in threading.enumerate()})
    out = {"shards": len(shards), "shard_sizes": sizes, "iterations": len(results),
           "updates": updates, "env_steps": algo._env_steps_total, "wall_s": wall,
           "priorities_returned": [bool(float(w.min()) < 1.0) for w in weights],
           "actor_threads_after_stop": alive, "placed": placed, "launches": launches}
    if (not all(sizes) or not any(out["priorities_returned"]) or alive or not updates
            or algo.replay_shards):
        fail(f"[rllib_algos apex] {out}")
    del algo, shards
    return out


def _get(ref):
    import ray_tpu_torch

    return ray_tpu_torch.get(ref, timeout=120.0)


def _algos_sac_td3(counters: dict, name: str, output: str) -> dict:
    """(c) SAC or TD3 on Pendulum-v1 at its config's defaults until
    ALGOS_SAC_UPDATES updates after the 1,000 env steps before learning;
    its rollouts tee to `output` (part e). SAC: alpha moved. TD3: the actor
    bit for bit unchanged across an off tick, moved on a delay tick."""
    from ray_tpu_torch.rllib.algorithms.sac import SACConfig
    from ray_tpu_torch.rllib.algorithms.td3 import TD3Config

    cfg_cls = SACConfig if name == "sac" else TD3Config
    algo = (cfg_cls().environment("Pendulum-v1").offline_data(output=output)
            .debugging(seed=RLLIB_SEED)).build()
    learner = algo.learner_group.local_learner
    tag = f"rllib_algos {name}"
    ticks = []
    if name == "td3":
        inner = learner.update

        def update(batch):
            step = learner.extra_train_state["step"]
            if len(ticks) < 4:
                pi = {k: v.detach().clone() for k, v in learner.module.params.items()
                      if k.startswith("pi.")}
            out = inner(batch)
            if len(ticks) < 4:
                same = all(torch.equal(learner.module.params[k], v) for k, v in pi.items())
                ticks.append({"step": step, "delay_tick": step % delay == 0,
                              "pi_unchanged": same})
            return out

        delay = algo.algo_config.policy_delay
        learner.update = update
    start = cfg_cls().num_steps_sampled_before_learning_starts
    out = _train_loop(algo, tag, counters,
                      lambda a, r: a._env_steps_total >= start + ALGOS_SAC_UPDATES)
    keys = ("total_loss", "critic_loss", "actor_loss", "mean_q") + (
        ("alpha_loss", "alpha") if name == "sac" else ())
    _finite(out["results"], keys, tag)
    last = out.pop("results")[-1]
    out["last"] = {k: last[k] for k in keys}
    out["episode_return_mean"] = last.get("episode_return_mean")
    if name == "sac" and not last["alpha"] != 1.0:
        fail(f"[{tag}] alpha did not move from 1.0: {last['alpha']}")
    if name == "td3":
        out["ticks"] = ticks
        if not ticks or any(t["pi_unchanged"] == t["delay_tick"] for t in ticks):
            fail(f"[{tag}] the actor moved on an off tick or stood on a delay tick: {ticks}")
    algo.stop()
    del algo, learner
    return out


def _algos_on_policy(counters: dict, name: str) -> dict:
    """(d) APPO on MinAtar-Breakout at bench_impala's shape and A2C on
    CartPole-v1 at bench_ppo's (envs, fragment, batch; A2C's one pass over
    the batch), 1 + ALGOS_ON_POLICY_ITERS train() calls."""
    from ray_tpu_torch.rllib.algorithms.a2c import A2CConfig
    from ray_tpu_torch.rllib.algorithms.appo import APPOConfig

    if name == "appo":
        p = RLLIB_IMPALA
        cfg = (APPOConfig().environment("MinAtar-Breakout")
               .env_runners(num_env_runners=1, num_envs_per_env_runner=p["envs"],
                            rollout_fragment_length=p["frag"])
               .training(train_batch_size=p["train_batch"]))
    else:
        p = RLLIB_PPO
        cfg = (A2CConfig().environment("CartPole-v1")
               .env_runners(num_env_runners=1, num_envs_per_env_runner=p["envs"],
                            rollout_fragment_length=p["frag"])
               .training(train_batch_size=p["train_batch"], minibatch_size=p["train_batch"]))
    algo = cfg.debugging(seed=RLLIB_SEED).build()
    learner = algo.learner_group.local_learner
    walls = _timed_updates(learner)
    _zero(counters)
    results = [algo.train()]
    steps0 = algo._env_steps_total
    t0 = time.perf_counter()
    for _ in range(ALGOS_ON_POLICY_ITERS):
        results.append(algo.train())
    dt = time.perf_counter() - t0
    launches = _read(counters)
    tag = f"rllib_algos {name}"
    _finite(results, ("total_loss", "policy_loss", "vf_loss"), tag)
    errors = [r["learner_error"] for r in results if "learner_error" in r]
    if errors or not walls:
        fail(f"[{tag}] learner errors {errors}, {len(walls)} updates")
    last = results[-1]
    out = {"env_steps_s": (algo._env_steps_total - steps0) / dt, "timed_s": dt,
           "update_p50_ms": statistics.median(walls) * 1e3, "updates": len(walls),
           "launches": launches, "placed": _check_placed(tag, learner),
           "last": {k: last[k] for k in ("total_loss", "policy_loss", "vf_loss", "entropy")
                    + (("mean_ratio",) if name == "appo" else ())},
           "episode_return_mean": [r.get("episode_return_mean") for r in results]}
    algo.stop()
    del algo, learner
    return out


def _algos_offline(counters: dict, sac_dir: str, ppo_dir: str) -> dict:
    """(e) PPO tees its CartPole rollouts to `ppo_dir` (ALGOS_PPO_LOG);
    BC trains from them and its NLL falls; CQL trains from SAC's Pendulum
    rollouts of part (c) in `sac_dir`, finite losses and penalty; IS and WIS
    of BC's policy from PPO's logs are finite."""
    from ray_tpu_torch.rllib.algorithms.bc import BCConfig
    from ray_tpu_torch.rllib.algorithms.cql import CQLConfig
    from ray_tpu_torch.rllib.algorithms.ppo import PPOConfig
    from ray_tpu_torch.rllib.offline import (
        ImportanceSampling,
        JsonReader,
        WeightedImportanceSampling,
        estimate_from_reader,
    )

    p = ALGOS_PPO_LOG
    ppo = (PPOConfig().environment("CartPole-v1")
           .env_runners(num_envs_per_env_runner=p["envs"], rollout_fragment_length=p["frag"])
           .training(train_batch_size=p["envs"] * p["frag"], minibatch_size=256, num_epochs=4,
                     lr=1e-3)
           .offline_data(output=ppo_dir).debugging(seed=RLLIB_SEED)).build()
    ppo_returns = [ppo.train().get("episode_return_mean") for _ in range(p["iters"])]
    ppo.stop()
    del ppo
    out = {"ppo_files": sorted(os.listdir(ppo_dir)), "ppo_returns": ppo_returns,
           "sac_files": len(os.listdir(sac_dir))}

    bc = (BCConfig().environment("CartPole-v1").offline_data(input_=ppo_dir)
          .training(train_batch_size=1024, lr=3e-3).debugging(seed=RLLIB_SEED)).build()
    _zero(counters)
    walls = _timed_updates(bc.learner_group.local_learner)
    nll = [bc.train()["bc_nll"] for _ in range(ALGOS_BC_ITERS)]
    out["bc"] = {"nll_first": nll[0], "nll_last5_mean": float(np.mean(nll[-5:])),
                 "update_p50_ms": statistics.median(walls) * 1e3, "launches": _read(counters),
                 "placed": _check_placed("rllib_algos bc", bc.learner_group.local_learner)}
    module = bc.get_module()

    def target_logp(obs, actions):
        with torch.no_grad():
            fwd = module.forward_train(module.params,
                                       {"obs": torch.as_tensor(obs, device=module.device)})
            dist = module.dist_cls(fwd["action_dist_inputs"])
            return dist.logp(torch.as_tensor(actions, device=module.device)).cpu().numpy()

    for est_cls in (ImportanceSampling, WeightedImportanceSampling):
        est = estimate_from_reader(est_cls(target_logp), JsonReader(ppo_dir, seed=RLLIB_SEED),
                                   num_batches=4)
        out[est_cls.__name__] = est
        if not (np.isfinite(est["v_target"]) and np.isfinite(est["v_behavior"])
                and est["num_episodes"] > 0):
            fail(f"[rllib_algos offline] {est_cls.__name__}: {est}")
    bc.stop()
    del bc, module
    if not all(np.isfinite(nll)) or not out["bc"]["nll_last5_mean"] < nll[0]:
        fail(f"[rllib_algos bc] the NLL did not fall: {out['bc']}")

    cql = (CQLConfig().environment("Pendulum-v1").offline_data(input_=sac_dir)
           .debugging(seed=RLLIB_SEED)).build()
    _zero(counters)
    walls = _timed_updates(cql.learner_group.local_learner)
    results = [cql.train() for _ in range(ALGOS_CQL_ITERS)]
    keys = ("total_loss", "critic_loss", "actor_loss", "alpha_loss", "cql_penalty")
    _finite(results, keys, "rllib_algos cql")
    out["cql"] = {"last": {k: results[-1][k] for k in keys},
                  "update_p50_ms": statistics.median(walls) * 1e3, "launches": _read(counters),
                  "placed": _check_placed("rllib_algos cql", cql.learner_group.local_learner)}
    cql.stop()
    del cql
    return out


def _algos_multi_agent(counters: dict) -> dict:
    """(f) MultiAgentCartPole at the reference tests' configurations: PPO
    with a shared policy (2 agents, fragment 32, batch 128, minibatch 64, 2
    epochs; 3 iterations), then per-policy PPO with two policies and a
    mapping function (max_steps 50, seed 7; 2 iterations): each policy's
    learner on cuda:0, their parameters different."""
    from ray_tpu_torch.rllib.algorithms.ppo import PPOConfig

    out = {}
    algo = (PPOConfig().environment("MultiAgentCartPole", env_config={"num_agents": 2})
            .env_runners(rollout_fragment_length=32)
            .training(train_batch_size=128, minibatch_size=64, num_epochs=2)
            .debugging(seed=0)).build()
    _zero(counters)
    t0 = time.perf_counter()
    results = [algo.train() for _ in range(3)]
    out["shared"] = {"wall_s": time.perf_counter() - t0, "launches": _read(counters),
                     "env_steps": results[-1]["num_env_steps_sampled_lifetime"],
                     "runner": type(algo.env_runner_group.local_runner).__name__,
                     "placed": _check_placed("rllib_algos multi-agent shared",
                                             algo.learner_group.local_learner)}
    _finite(results, ("total_loss",), "rllib_algos multi-agent shared")
    algo.stop()
    del algo
    algo = (PPOConfig().environment("MultiAgentCartPole",
                                    env_config={"num_agents": 2, "max_steps": 50})
            .multi_agent(policies=["left", "right"],
                         policy_mapping_fn=lambda aid, **kw: "left" if str(aid).endswith("0")
                         else "right")
            .env_runners(rollout_fragment_length=32)
            .training(train_batch_size=128, minibatch_size=64, num_epochs=2)
            .debugging(seed=7)).build()
    _zero(counters)
    t0 = time.perf_counter()
    results = [algo.train() for _ in range(2)]
    group = algo.learner_group.local_learner
    w = {pid: group[pid].module.params for pid in ("left", "right")}
    differ = any(not torch.equal(w["left"][k], w["right"][k]) for k in w["left"])
    out["per_policy"] = {
        "wall_s": time.perf_counter() - t0, "launches": _read(counters),
        "policies_in_results": sorted({k.split("/")[0] for k in results[-1] if "/" in k}),
        "params_differ": differ,
        "placed": {pid: _check_placed(f"rllib_algos multi-agent {pid}", group[pid])
                   for pid in w}}
    if not differ or out["per_policy"]["policies_in_results"] != ["left", "right"]:
        fail(f"[rllib_algos multi-agent] per-policy: {out['per_policy']}")
    algo.stop()
    del algo, group, w
    return out


def _parity_batches() -> dict:
    """Each learner's batch, sampled on the host: DQN's and BC's and A2C's
    from CartPole-v1, SAC/TD3/CQL's from Pendulum-v1, APPO's from
    MinAtar-Breakout fragments."""
    from ray_tpu_torch.rllib.algorithms.appo import APPOConfig
    from ray_tpu_torch.rllib.algorithms.ppo import PPOConfig
    from ray_tpu_torch.rllib.evaluation.env_runner import EnvRunner

    def sample(cfg):
        runner = EnvRunner(cfg.debugging(seed=RLLIB_SEED))
        batch = runner.sample()
        runner.stop()
        return batch

    cart = sample(PPOConfig().environment("CartPole-v1")
                  .env_runners(num_envs_per_env_runner=16, rollout_fragment_length=32))
    pend = sample(PPOConfig().environment("Pendulum-v1")
                  .env_runners(num_envs_per_env_runner=8, rollout_fragment_length=32))
    minatar = sample(APPOConfig().environment("MinAtar-Breakout")
                     .env_runners(num_envs_per_env_runner=32, rollout_fragment_length=64))
    return {"cart": cart, "pend": pend, "minatar": minatar}


def _algos_parity(card: str) -> dict:
    """(g) One update of each new learner in f32 on cuda:0 and on the CPU
    from the same weights, on the same batch, row orders and noise (the
    CPU learner's draws, copied to the card): each tensor's change and the
    metrics held by RLLIB_PARITY (DQN's per-sample TD errors among them)."""
    from ray_tpu_torch.rllib.algorithms.a2c import A2CConfig, A2CLearner
    from ray_tpu_torch.rllib.algorithms.appo import APPOConfig, APPOLearner
    from ray_tpu_torch.rllib.algorithms.bc import BCConfig, BCLearner
    from ray_tpu_torch.rllib.algorithms.cql import CQLConfig, CQLLearner
    from ray_tpu_torch.rllib.algorithms.dqn import DQNConfig, DQNLearner, DQNModule
    from ray_tpu_torch.rllib.algorithms.sac import SACConfig, SACLearner, SACModule
    from ray_tpu_torch.rllib.algorithms.td3 import TD3Config, TD3Learner, TD3Module
    from ray_tpu_torch.rllib.core.rl_module import RLModule, RLModuleSpec
    from ray_tpu_torch.rllib.env import make_env

    batches = _parity_batches()
    cases = (
        ("dqn", DQNConfig(), DQNLearner, DQNModule,
         "CartPole-v1", "cart"),
        ("sac", SACConfig(), SACLearner, SACModule, "Pendulum-v1", "pend"),
        ("td3", TD3Config(), TD3Learner, TD3Module, "Pendulum-v1", "pend"),
        ("cql", CQLConfig(), CQLLearner, SACModule, "Pendulum-v1", "pend"),
        ("a2c", A2CConfig().training(minibatch_size=256), A2CLearner, RLModule,
         "CartPole-v1", "cart"),
        ("appo", APPOConfig().training(use_kl_loss=True).env_runners(rollout_fragment_length=64),
         APPOLearner, RLModule, "MinAtar-Breakout", "minatar"),
        ("bc", BCConfig().training(minibatch_size=256), BCLearner, RLModule, "CartPole-v1",
         "cart"),
    )
    out = {}
    for name, cfg, learner_cls, module_cls, env, which in cases:
        batch = batches[which]
        if name == "dqn":
            batch = type(batch)(dict(batch))
            batch["weights"] = np.linspace(0.25, 1.0, batch.count, dtype=np.float32)
        probe = make_env(env)
        spec = RLModuleSpec(module_class=module_cls, observation_space=probe.observation_space,
                            action_space=probe.action_space, seed=RLLIB_SEED)
        cfg = cfg.debugging(seed=RLLIB_SEED)
        learners = {d: learner_cls(spec, cfg, device=d) for d in ("cpu", "cuda")}
        for learner in learners.values():
            learner.build()
        learners["cuda"].set_weights(learners["cpu"].get_weights())
        drawn: list = []
        cpu_noise, cuda_noise = learners["cpu"].sample_noise, learners["cuda"].sample_noise

        def draw_cpu(b, inner=cpu_noise):
            z = inner(b)
            drawn.append(z)
            return z

        def draw_cuda(b, inner=cuda_noise, device=learners["cuda"].device):
            z = drawn.pop(0)
            if isinstance(z, dict):
                return {k: v.to(device) for k, v in z.items()}
            return inner(b)

        learners["cpu"].sample_noise = draw_cpu
        learners["cuda"].sample_noise = draw_cuda
        before = learners["cpu"].get_weights()
        metrics = {d: learners[d].update(batch) for d in ("cpu", "cuda")}
        after = {d: learner.get_weights() for d, learner in learners.items()}
        lr = learners["cpu"].optimizer.lr
        worst = {"rel_l2": 0.0, "lr_share": 0.0, "metrics_rel": 0.0, "moved": 0, "still": 0}
        for k, b in before.items():
            d_card, d_cpu = after["cuda"][k] - b, after["cpu"][k] - b
            norm = float(torch.linalg.vector_norm(d_cpu))
            if norm == 0.0:  # BC's value head: not reached by the loss
                worst["still"] += 1
                worst["rel_l2"] = max(worst["rel_l2"], float(torch.linalg.vector_norm(d_card)))
                continue
            worst["moved"] += 1
            worst["rel_l2"] = max(worst["rel_l2"], float(
                torch.linalg.vector_norm(d_card - d_cpu)) / norm)
            worst["lr_share"] = max(worst["lr_share"], float((d_card - d_cpu).abs().max()) / lr)
        for k, v in metrics["cpu"].items():
            got = np.asarray(metrics["cuda"][k], np.float64)
            v = np.asarray(v, np.float64)
            worst["metrics_rel"] = max(worst["metrics_rel"], float(
                np.max(np.abs(got - v) / np.maximum(np.abs(v), 1e-2))))
        out[name] = {"rows": batch.count, "steps": learners["cpu"]._opt_state["count"],
                     "lr": lr, **worst}
        log(f"[rllib_algos parity] ({card}) {name}: " + json.dumps(out[name]))
        if (worst["rel_l2"] > RLLIB_PARITY["rel_l2"]
                or worst["lr_share"] > RLLIB_PARITY["lr_share"]
                or worst["metrics_rel"] > RLLIB_PARITY["metrics_rtol"] or not worst["moved"]):
            fail(f"[rllib_algos parity] {name}: card against CPU beyond {RLLIB_PARITY}: "
                 f"{out[name]}")
        del learners, before, after
    return out


def _algos_log(name: str, card: str, part: dict) -> None:
    """The `[rllib_algos]` lines of one part, printed as it ends."""
    launched = {}
    for key in ("launches",):
        launched.update({k: n for k, n in part.get(key, {}).items() if n})
    for sub in ("bc", "cql", "shared", "per_policy"):
        if isinstance(part.get(sub), dict):
            launched.update({f"{sub} {k}": n for k, n in part[sub].get("launches", {}).items()
                             if n})
    if launched:
        fail(f"[rllib_algos {name}] attention kernels launched on RLlib's path: {launched}")
    brief = {k: v for k, v in part.items() if k not in ("launches",)}
    log(f"[rllib_algos] ({card}) {name}: " + json.dumps(brief, default=str))


def phase_rllib_algos(device_info: dict) -> dict:
    """The rest of RLlib on the port, every learner on cuda:0, the envs,
    replay and offline files on the host: (a) DQN on CartPole-v1 at its
    defaults, uniform and n_step=3 prioritized replay, ALGOS_DQN_STEPS env
    steps each; (b) Ape-X with 2 shards and 2 runners; (c) SAC and TD3 on
    Pendulum-v1 at their defaults, ALGOS_SAC_UPDATES updates each, their
    rollouts teed to disk; (d) APPO at bench_impala's shape and A2C at
    bench_ppo's; (e) offline: PPO's teed rollouts train BC, SAC's train CQL,
    IS and WIS over the logs; (f) multi-agent PPO, shared and per-policy;
    (g) f32 card against CPU of one update of each new learner. The
    attention counters are set to 0 before each path and read after (none
    may launch); the card memory after each part within LEFT_LIMIT_MIB of
    its figure before."""
    import shutil
    import tempfile

    import ray_tpu_torch

    t_phase = time.perf_counter()
    card = device_info["smi"]
    counters = _attention_counters()
    summary = {}
    logs = tempfile.mkdtemp(prefix="rllib_algos_")
    sac_dir, td3_dir, ppo_dir = (os.path.join(logs, d) for d in ("sac", "td3", "ppo"))
    ray_tpu_torch.init(num_cpus=8, num_gpus=1)
    try:
        for name, run in (("dqn", lambda: _algos_dqn(counters, False)),
                          ("dqn_prioritized", lambda: _algos_dqn(counters, True)),
                          ("apex", lambda: _algos_apex(counters)),
                          ("sac", lambda: _algos_sac_td3(counters, "sac", sac_dir)),
                          ("td3", lambda: _algos_sac_td3(counters, "td3", td3_dir)),
                          ("appo", lambda: _algos_on_policy(counters, "appo")),
                          ("a2c", lambda: _algos_on_policy(counters, "a2c")),
                          ("offline", lambda: _algos_offline(counters, sac_dir, ppo_dir)),
                          ("multi_agent", lambda: _algos_multi_agent(counters)),
                          ("parity", lambda: _algos_parity(card))):
            mem0 = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            summary[name] = run()
            summary[name]["part_s"] = time.perf_counter() - t0
            summary[name]["left_mib"] = _settle(mem0, f"rllib_algos {name}")
            _algos_log(name, card, summary[name])
    finally:
        ray_tpu_torch.shutdown()
        shutil.rmtree(logs, ignore_errors=True)
    summary["wall_s"] = time.perf_counter() - t_phase
    log(f"[rllib_algos] phase wall {summary['wall_s']:.1f}s")
    return summary


# The data phase: Ray Data (ray_tpu_torch.data) feeding TorchTrainer through
# datasets=, streamed by the port's executor and copied to the card by
# iter_device_batches. GPT-2 125M on two workers at half the card each: N =
# workers x rows a step x steps seeded token rows in DATA_BLOCKS blocks (each
# block's rows a multiple of the block count, so the seeded shuffle's
# repartition keeps every block the same size and the round-robin split
# gives each rank the same rows). ResNet-50 at bench.py's shape from seeded
# uint8 images made on the host.
DATA_WORKERS, DATA_GPU = 2, 0.5
DATA_GPT_B, DATA_GPT_STEPS, DATA_BLOCKS = 8, 5, 4
DATA_ROW_KEY = 8  # leading tokens that name a row (asserted unique)
DATA_RESNET_WARMUP, DATA_RESNET_TIMED = 2, 5
_DATA = {"lock": threading.Lock(), "ranks": {}}


def _data_device_batches() -> dict:
    """range_tensor(96, shape=(8,)) through iter_device_batches(batch_size=32)
    on cuda:0: 3 batches of (32, 8) on cuda:0, bit for bit iter_batches'
    host batches, and the copy of batch N+1 enqueued before batch N was
    handed out (the iterator's own order log)."""
    from ray_tpu_torch import data as rd

    ds = rd.range_tensor(96, shape=(8,), parallelism=4)
    host = list(ds.iter_batches(batch_size=32, drop_last=True))
    it = ds.iter_device_batches(batch_size=32)
    got = list(it)
    torch.cuda.synchronize()
    if len(got) != 3 or len(host) != 3:
        fail(f"[data] device batches: {len(got)} on the card, {len(host)} on the host, not 3")
    for g, h in zip(got, host):
        t = g["data"]
        if t.device != torch.device("cuda", 0) or tuple(t.shape) != (32, 8):
            fail(f"[data] device batch on {t.device}, shape {tuple(t.shape)}")
        if not torch.equal(t.cpu(), torch.from_numpy(h["data"])):
            fail("[data] a device batch differs from its host batch")
    ahead = all(it.order.index(("copy", n + 1)) < it.order.index(("yield", n))
                for n in range(len(got) - 1))
    if not ahead or it.copies_ahead != len(got) - 1:
        fail(f"[data] the next batch's copy was not enqueued before a batch was "
             f"handed out: {it.order}")
    out = {"batches": len(got), "shape": [32, 8], "dtype": str(got[0]["data"].dtype),
           "bit_for_bit": True, "order": [f"{a} {n}" for a, n in it.order],
           "copies_ahead": it.copies_ahead}
    log("[data] device batches: " + json.dumps(out))
    return out


def _data_gpt_loop(config):
    """A worker's loop: GPT-2 125M (attention_impl="auto", bf16 on f32
    parameters) takes one fused_adamw step on each batch of its shard of
    the Dataset, read with iter_device_batches on its device. Per rank it
    records in _DATA the leading tokens of each batch's rows, the losses,
    each step's wall and the wait for each batch."""
    from ray_tpu_torch import train
    from ray_tpu_torch.models import cross_entropy_loss
    from ray_tpu_torch.models.gpt import GPT, gpt2_125m
    from ray_tpu_torch.ops import fused_adamw

    device = train.get_device()
    rank = train.get_world_rank()
    model = GPT(gpt2_125m(attention_impl="auto"), device=device, seed=0)
    params = dict(model.named_parameters())
    opt = fused_adamw(LR)
    state = {"opt": opt.init(params)}

    def step(batch):
        loss = cross_entropy_loss(model(batch["input"]), batch["target"])
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        _, state["opt"] = opt.apply(grads, state["opt"], params)
        return loss.detach()

    step = train.prepare_step(step)
    seen = {"rows": [], "losses": [], "step_s": [], "wait_s": [], "devices": set(),
            "dtypes": set()}
    shard = train.get_dataset_shard("train")
    t_wait = time.perf_counter()
    for i, batch in enumerate(shard.iter_device_batches(batch_size=DATA_GPT_B, device=device)):
        seen["wait_s"].append(time.perf_counter() - t_wait)
        seen["devices"].update(str(t.device) for t in batch.values())
        seen["dtypes"].update(str(t.dtype) for t in batch.values())
        t0 = time.perf_counter()
        loss = step(batch)
        wall = time.perf_counter() - t0
        seen["rows"] += batch["input"][:, :DATA_ROW_KEY].cpu().tolist()
        seen["losses"].append(loss.item())
        seen["step_s"].append(wall)
        train.report({"step": i, "loss": seen["losses"][-1], "step_s": wall})
        t_wait = time.perf_counter()
    with _DATA["lock"]:
        _DATA["ranks"][rank] = seen


def _data_images(batch: dict) -> dict:
    """map_batches fn: seeded uint8 HWC images (RESNET_HW square, 3
    channels) and int64 labels for a block of ids, seeded by its first id."""
    ids = batch["id"]
    rng = np.random.default_rng(int(ids[0]))
    return {"image": rng.integers(0, 256, (len(ids), RESNET_HW, RESNET_HW, 3), dtype=np.uint8),
            "label": rng.integers(0, 1000, len(ids), dtype=np.int64)}


def _checksums(flat) -> list:
    """The plain and the position-weighted sum of a flat integer array
    (a torch tensor on any device, or numpy)."""
    if isinstance(flat, torch.Tensor):
        flat = flat.to(torch.int64)
        weight = torch.arange(flat.numel(), device=flat.device) % 65521 + 1
        return [flat.sum().item(), (flat * weight).sum().item()]
    flat = flat.astype(np.int64)
    weight = np.arange(flat.size, dtype=np.int64) % 65521 + 1
    return [int(flat.sum()), int((flat * weight).sum())]


def _data_resnet_loop(config):
    """The worker's loop: ResNet-50 (bf16 on f32 parameters, GroupNorm,
    SGD(0.1, momentum 0.9)) on batches read with iter_device_batches,
    scaled on the card from uint8 into bf16 in [-1, 1]. Each step reports
    its loss, the step's wall and the iteration's (the wait for the batch,
    the scaling and the step); the first also the checksums of its images
    on the card."""
    from ray_tpu_torch import train
    from ray_tpu_torch.models import ResNet50

    device = train.get_device()
    model = ResNet50(num_classes=1000, device=device, seed=0)
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    step = train.prepare_step(lambda images, labels: _resnet_step(model, opt, images, labels))
    shard = train.get_dataset_shard("train")
    t_iter = time.perf_counter()
    for i, batch in enumerate(shard.iter_device_batches(batch_size=RESNET_B, device=device)):
        raw = batch["image"]
        checksums = _checksums(raw.reshape(-1)) if i == 0 else None
        images = (raw.float() * (2.0 / 255.0) - 1.0).to(torch.bfloat16)
        t0 = time.perf_counter()
        loss = step(images, batch["label"]).item()
        t1 = time.perf_counter()
        train.report({"step": i, "warmup": i < config["warmup"], "loss": loss,
                      "step_s": t1 - t0, "iter_s": t1 - t_iter, "checksums": checksums,
                      "device": str(raw.device), "dtype": str(raw.dtype),
                      "label_dtype": str(batch["label"].dtype)})
        t_iter = time.perf_counter()


def _data_fit(loop, ds, scaling, config, counters) -> tuple:
    """TorchTrainer(datasets={"train": ds}, instrumented) on cuda:0 with the
    launch counters set to 0 just before fit() and read just after, the
    card memory after it within LEFT_LIMIT_MIB of the figure before."""
    from ray_tpu_torch.train import TorchBackendConfig, TorchTrainer, TrainConfig

    trainer = TorchTrainer(
        loop, train_loop_config=config, datasets={"train": ds}, scaling_config=scaling,
        backend_config=TorchBackendConfig(device="cuda:0"),
        train_config=TrainConfig(instrument=True))
    gc.collect()
    torch.cuda.empty_cache()
    mem0 = torch.cuda.memory_allocated()
    for f in counters.values():
        f.launches = 0
    t0 = time.perf_counter()
    result = trainer.fit()
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = {k: f.launches for k, f in counters.items()}
    if result.error is not None:
        fail(f"[data] TorchTrainer.fit() failed: {result.error!r}")
    del trainer
    return result, wall, launches, mem0


def _round_shares(report: dict) -> dict:
    """From a train_report: each round's data_wait share per rank
    (data_wait over the round's duration), samples a second by round (all
    ranks' samples over the slowest rank's duration), and the data_blame
    each rank's rounds carried."""
    shares, rates, blame = [], [], set()
    for row in report["rounds"]:
        ranks = row["ranks"]
        shares.append([r["phases"]["data_wait"] / r["duration_s"] for r in ranks])
        rates.append(sum(r["samples"] for r in ranks) / max(r["duration_s"] for r in ranks))
        blame.update(r.get("data_blame") for r in ranks if r.get("data_blame"))
    return {"data_wait_share_by_round": shares, "samples_per_s_by_round": rates,
            "data_blame": sorted(blame)}


def _data_gpt(trainer: dict, counters: dict) -> dict:
    """GPT-2 125M from a Dataset through TorchTrainer on two workers at half
    the card each: launches (K2 and K3 12 a step per worker, K4-K7 none),
    finite losses, the ranks' rows disjoint and every row read once."""
    from ray_tpu_torch import data as rd
    from ray_tpu_torch.models.gpt import gpt2_125m
    from ray_tpu_torch.train import ScalingConfig

    layers = gpt2_125m().num_layers
    n_rows = DATA_WORKERS * DATA_GPT_B * DATA_GPT_STEPS
    tokens = np.random.RandomState(0).randint(0, 50257, (n_rows, TRAIN_S + 1)).astype(np.int64)
    keys = {tuple(row[:DATA_ROW_KEY]): r for r, row in enumerate(tokens.tolist())}
    if len(keys) != n_rows:
        fail("[data gpt2] the rows' leading tokens do not name them apart")
    per_block = n_rows // DATA_BLOCKS
    ds = (rd.from_numpy([tokens[b * per_block:(b + 1) * per_block] for b in range(DATA_BLOCKS)])
          .random_shuffle(seed=0)
          .map_batches(lambda b: {"input": b["data"][:, :-1], "target": b["data"][:, 1:]}))
    _DATA["ranks"] = {}
    scaling = ScalingConfig(num_workers=DATA_WORKERS, resources_per_worker={"GPU": DATA_GPU})
    result, wall, launches, mem0 = _data_fit(_data_gpt_loop, ds, scaling, {}, counters)
    ranks = dict(_DATA["ranks"])
    _DATA["ranks"] = {}
    want = {k: (layers * DATA_GPT_STEPS * DATA_WORKERS
                if k in ("K2 flash_fwd", "K3 flash_bwd_fused") else 0)
            for k in launches if k != "K1 paged_attention"}
    got = {k: v for k, v in launches.items() if k != "K1 paged_attention"}
    if got != want:
        fail(f"[data gpt2] launches {got}, not {want}")
    if sorted(ranks) != list(range(DATA_WORKERS)):
        fail(f"[data gpt2] ranks that finished: {sorted(ranks)}")
    rows = {r: [keys.get(tuple(k)) for k in seen["rows"]] for r, seen in ranks.items()}
    everything = [x for r in rows.values() for x in r]
    if None in everything or sorted(everything) != list(range(n_rows)):
        fail(f"[data gpt2] the ranks' rows are not every row once: {rows}")
    for r, seen in ranks.items():
        if len(seen["losses"]) != DATA_GPT_STEPS or not all(np.isfinite(seen["losses"])):
            fail(f"[data gpt2] rank {r} losses {seen['losses']}")
        if seen["devices"] != {"cuda:0"} or seen["dtypes"] != {"torch.int64"}:
            fail(f"[data gpt2] rank {r} batches on {seen['devices']} as {seen['dtypes']}")
    steps = [s for seen in ranks.values() for s in seen["step_s"][1:]]
    shares = _round_shares(result.train_report)
    out = {
        "model": "gpt2_125m bf16 (f32 params), attention_impl=auto, from a Dataset",
        "workers": DATA_WORKERS, "gpu_per_worker": DATA_GPU, "B": DATA_GPT_B, "S": TRAIN_S,
        "steps": DATA_GPT_STEPS, "rows": n_rows, "blocks": DATA_BLOCKS,
        "rows_by_rank": {r: sorted(v) for r, v in rows.items()},
        "losses_by_rank": {r: seen["losses"] for r, seen in ranks.items()},
        "step_s_by_rank": {r: seen["step_s"] for r, seen in ranks.items()},
        "batch_wait_s_by_rank": {r: seen["wait_s"] for r, seen in ranks.items()},
        "step_p50_s": statistics.median(steps),
        "trainer_phase_step_p50_s": trainer["step_p50_s"],
        "samples_total": result.train_report["samples_total"],
        "samples_per_s_p50": statistics.median(shares["samples_per_s_by_round"][1:]),
        **shares, "fit_wall_s": wall, "launches": launches,
    }
    if out["samples_total"] != n_rows:
        fail(f"[data gpt2] samples clock {out['samples_total']}, not {n_rows}")
    del result
    out["left_mib"] = _settle(mem0, "data gpt2")
    return out


def _data_resnet(resnet: dict, counters: dict) -> dict:
    """ResNet-50 at bench.py's shape from a Dataset of seeded uint8 images
    made on the host, through TorchTrainer on one worker on cuda:0: no
    attention kernel launched, finite losses, the first batch's checksums
    on the card equal to the host's."""
    from ray_tpu_torch import data as rd
    from ray_tpu_torch.train import ScalingConfig

    n = DATA_RESNET_WARMUP + DATA_RESNET_TIMED
    ds = rd.range(RESNET_B * n, parallelism=n).map_batches(_data_images, batch_size=RESNET_B)
    host_first = _checksums(_data_images({"id": np.arange(RESNET_B)})["image"].reshape(-1))
    result, wall, launches, mem0 = _data_fit(
        _data_resnet_loop, ds, ScalingConfig(num_workers=1),
        {"warmup": DATA_RESNET_WARMUP}, counters)
    history = result.metrics_history
    losses = [m["loss"] for m in history]
    if len(history) != n or not all(np.isfinite(losses)):
        fail(f"[data resnet] losses {losses}")
    if any(launches.values()):
        fail(f"[data resnet] attention kernels launched on the ResNet path: {launches}")
    first = history[0]
    if first["checksums"] != host_first:
        fail(f"[data resnet] first batch's checksums {first['checksums']} on the card, "
             f"{host_first} on the host")
    if {(m["device"], m["dtype"], m["label_dtype"]) for m in history} != {
            ("cuda:0", "torch.uint8", "torch.int64")}:
        fail(f"[data resnet] batches not uint8 / int64 on cuda:0: {history[0]}")
    timed = [m for m in history if not m["warmup"]]
    iter_p50 = statistics.median(m["iter_s"] for m in timed)
    shares = _round_shares(result.train_report)
    out = {
        "model": "resnet50 bf16 (f32 params), GroupNorm, SGD(0.1, momentum 0.9), from a Dataset",
        "B": RESNET_B, "HW": RESNET_HW, "batch_mb": RESNET_B * RESNET_HW * RESNET_HW * 3 / 1e6,
        "steps": {"warmup": DATA_RESNET_WARMUP, "timed": DATA_RESNET_TIMED},
        "losses": losses, "step_s": [m["step_s"] for m in history],
        "iter_s": [m["iter_s"] for m in history],
        "step_p50_s": statistics.median(m["step_s"] for m in timed), "iter_p50_s": iter_p50,
        "images_per_s": RESNET_B / iter_p50,
        "resnet_phase_images_per_s": resnet["images_per_s"],
        "first_batch_checksums": first["checksums"], **shares,
        "fit_wall_s": wall, "launches": launches,
    }
    del result, history
    out["left_mib"] = _settle(mem0, "data resnet")
    return out


def phase_data(device_info: dict, trainer: dict, resnet: dict) -> dict:
    """Ray Data on the port feeding the trainer on the card (phase 17):
    device batches one batch ahead; GPT-2 125M from a shuffled Dataset on
    two workers at half the card; ResNet-50 B256 from a Dataset of host
    images. Each fit() with the attention counters set to 0 just before it
    and read just after, and the card memory after it within LEFT_LIMIT_MIB
    of its figure before."""
    import ray_tpu_torch

    t_phase = time.perf_counter()
    card = device_info["smi"]
    counters = _attention_counters()
    summary = {}
    ray_tpu_torch.init(num_cpus=8, num_gpus=1)
    try:
        summary["device_batches"] = _data_device_batches()
        summary["gpt2"] = _data_gpt(trainer, counters)
        log("[data] gpt2 " + json.dumps({"card": card, **summary["gpt2"]}))
        summary["resnet"] = _data_resnet(resnet, counters)
        log("[data] resnet " + json.dumps({"card": card, **summary["resnet"]}))
    finally:
        ray_tpu_torch.shutdown()
    g, r = summary["gpt2"], summary["resnet"]
    log(f"[data] gpt2 from a Dataset: step p50 {g['step_p50_s'] * 1e3:.1f} ms on two workers "
        f"sharing the card (trainer phase, one worker: {g['trainer_phase_step_p50_s'] * 1e3:.1f} "
        f"ms), {g['samples_per_s_p50']:.1f} samples/s, data_blame {g['data_blame']}; resnet50 "
        f"from a Dataset: {r['images_per_s']:.1f} images/s (resnet phase, data on the card: "
        f"{r['resnet_phase_images_per_s']:.1f}); {card}")
    summary["wall_s"] = time.perf_counter() - t_phase
    log(f"[data] phase wall {summary['wall_s']:.1f}s")
    return summary


# The procs phase (18): GPT-2 125M in GPU actors and tasks that own their
# worker processes and CUDA contexts (isolation="process"): served through
# an ActorPool, one server OOM-killed by the memory monitor (its memory
# fraction injected) and restarted, trained and evaluated by a DAG and by a
# workflow resumed after a failure, and trained by TorchTrainer on two worker
# processes at half the card each. Launch counters live in the process that
# launches, so each actor or task zeroes its own just before its path and
# reports them just after, and the phase sums them. The driver holds no card
# memory of this phase: the card's figures are device-wide (mem_get_info).
PROCS_GPU = 0.5
PROCS_HOLD_S = 30.0  # the victim's call in flight while the monitor decides
PROCS_EVAL_SEED = 1
PROCS_TIMEOUT_S = 300.0
PROCS_TALLY = "procs_tally"


class _Fraction:
    """The memory monitor's injected host-memory fraction."""

    def __init__(self, value: float):
        self.value = value

    def __call__(self) -> float:
        return self.value


def _device_used() -> int:
    """Bytes in use on the whole card: every process's contexts and
    allocations (the driver's memory_allocated sees only its own)."""
    free, total = torch.cuda.mem_get_info()
    return total - free


def _pid_alive(pid: int) -> bool:
    """True while the process exists and is not a zombie."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except (OSError, IndexError):
        return False


def _own_counts(zero: bool = False) -> dict:
    """This process's attention-kernel launch counts, zeroed first when
    `zero`: what a GPU actor or task reports of its own path."""
    counters = _attention_counters()
    if zero:
        for f in counters.values():
            f.launches = 0
    return {k: f.launches for k, f in counters.items()}


def _sum_counts(parts) -> dict:
    out = {}
    for part in parts:
        for k, v in part.items():
            out[k] = out.get(k, 0) + v
    return out


def _want_counts(counts: dict, launched: dict, phase: str = "procs") -> None:
    """`counts` must be `launched` for those kernels and 0 for the rest."""
    want = {k: launched.get(k, 0) for k in counts}
    if counts != want:
        fail(f"[{phase}] launches {counts}, not {want}")


def _until(cond, what: str, deadline_s: float = 30.0, phase: str = "procs") -> float:
    """Seconds until cond() holds; fails after `deadline_s`."""
    t0 = time.perf_counter()
    while not cond():
        if time.perf_counter() - t0 > deadline_s:
            fail(f"[{phase}] {what}: not within {deadline_s:.0f}s")
        time.sleep(0.05)
    return time.perf_counter() - t0


class _GPTServerActor:
    """An LLMServer on the card in a worker process of its own."""

    def __init__(self, cfg, ecfg, device):
        from ray_tpu_torch.llm import LLMServer

        self.server = LLMServer(cfg, ecfg, seed=0, device=device)

    def info(self) -> dict:
        return {"pid": os.getpid(), "ppid": os.getppid(),
                "device": torch.cuda.current_device(),
                "reserved": torch.cuda.memory_reserved()}

    def zero(self) -> None:
        _own_counts(zero=True)

    def counts(self) -> dict:
        return _own_counts()

    def generate(self, i, prompt, n_new) -> tuple:
        """Prompt `i` alone, from an empty prefix cache."""
        self.server.reset_prefix_cache()
        return i, self.server.generate(prompt, max_new_tokens=n_new)["token_ids"]

    def hold(self, seconds: float) -> None:
        time.sleep(seconds)


class _Tally:
    """Launch counts the trainer's worker processes report, by pid."""

    def __init__(self):
        self.parts = {}

    def add(self, pid: int, counts: dict) -> None:
        self.parts[pid] = counts

    def read(self) -> dict:
        return dict(self.parts)


def _procs_map(pool, actors, prompts, n_new, want) -> dict:
    """The prompts through pool.map_unordered with every actor's counters
    set to 0 just before and read just after: tokens identical to `want`,
    K1 and K2 launched."""
    import ray_tpu_torch

    ray_tpu_torch.get([a.zero.remote() for a in actors], timeout=PROCS_TIMEOUT_S)
    t0 = time.perf_counter()
    got = dict(pool.map_unordered(lambda a, item: a.generate.remote(*item, n_new),
                                  list(enumerate(prompts))))
    wall = time.perf_counter() - t0
    launches = _sum_counts(ray_tpu_torch.get([a.counts.remote() for a in actors],
                                             timeout=PROCS_TIMEOUT_S))
    tokens = [got.get(i) for i in range(len(prompts))]
    if tokens != want:
        bad = [i for i, (g, w) in enumerate(zip(tokens, want)) if g != w]
        fail(f"[procs] prompts {bad}: the actors' tokens differ from the in-process "
             "server's")
    for name in ("K1 paged_attention", "K2 flash_fwd"):
        if launches[name] <= 0:
            fail(f"[procs] {name} was not launched in the actors: {launches}")
    return {"requests": len(prompts), "tokens": n_new * len(prompts), "wall_s": wall,
            "tokens_per_s": n_new * len(prompts) / wall, "token_identical": True,
            "launches": launches}


def _procs_pool(runtime, fraction, server: dict, card: str, pids: set) -> tuple:
    """Two GPT-2 125M servers at half the card each behind an ActorPool;
    then one of them OOM-killed by the memory monitor and restarted."""
    import ray_tpu_torch
    from ray_tpu_torch.exceptions import ActorDiedError
    from ray_tpu_torch.models.gpt import gpt2_125m
    from ray_tpu_torch.util.actor_pool import ActorPool

    n_new = 32
    prompts = _prompts(np.random.RandomState(0))
    want = server["bf16_cold_tokens"]
    cls = ray_tpu_torch.remote(_GPTServerActor).options(num_gpus=PROCS_GPU, max_restarts=1)
    t0 = time.perf_counter()
    actors = [cls.remote(gpt2_125m(), _engine_config(), "cuda") for _ in range(2)]
    infos = ray_tpu_torch.get([a.info.remote() for a in actors], timeout=PROCS_TIMEOUT_S)
    up_s = time.perf_counter() - t0
    apids = [i["pid"] for i in infos]
    pids.update(apids)
    if len(set(apids)) != 2 or os.getpid() in apids:
        fail(f"[procs] actor pids {apids}, driver {os.getpid()}")
    pool = ActorPool(actors)
    first = _procs_map(pool, actors, prompts, n_new, want)
    first.update(actors=infos, driver_pid=os.getpid(), up_s=up_s)
    log("[procs] actor_pool " + json.dumps({"card": card, **first}))

    # One server busy (the monitor kills only workers with work in flight)
    # while the fraction reads 0.99: the monitor kills it, and its card
    # memory returns, before the fraction falls and the restart may begin.
    victim = actors[1]
    held = ray_tpu_torch.get(victim.info.remote(), timeout=PROCS_TIMEOUT_S)["reserved"]
    used_before = _device_used()
    kills0 = runtime.memory_monitor.kills
    hold = victim.hold.remote(PROCS_HOLD_S)
    time.sleep(0.5)  # the call is in flight
    fraction.value = 0.99
    kill_s = _until(lambda: runtime.memory_monitor.kills > kills0, "an OOM kill")
    exit_s = _until(lambda: not _pid_alive(apids[1]), "the killed actor's exit")
    back_s = _until(lambda: used_before - _device_used() >= held,
                    "the killed actor's card memory returning")
    dropped = used_before - _device_used()
    try:
        ray_tpu_torch.get(hold, timeout=PROCS_TIMEOUT_S)
        fail("[procs] the killed actor's call returned")
    except ActorDiedError as exc:
        death = str(exc)
    if not _pid_alive(apids[0]):
        fail("[procs] the monitor killed both actors")
    fraction.value = 0.5
    t0 = time.perf_counter()
    while True:
        try:
            again = ray_tpu_torch.get(victim.info.remote(), timeout=PROCS_TIMEOUT_S)
            break
        except ActorDiedError:
            if time.perf_counter() - t0 > PROCS_TIMEOUT_S:
                fail("[procs] the killed actor never restarted")
            time.sleep(0.2)
    restart_s = time.perf_counter() - t0
    pids.add(again["pid"])
    if again["pid"] in apids:
        fail(f"[procs] the restarted actor runs in pid {again['pid']}")
    second = _procs_map(pool, actors, prompts, n_new, want)
    oom = {**second, "kills": runtime.memory_monitor.kills - kills0,
           "killed_pid": apids[1], "restarted_pid": again["pid"],
           "held_reserved_mib": held / 2**20, "device_used_drop_mib": dropped / 2**20,
           "kill_s": kill_s, "exit_s": exit_s, "memory_back_s": back_s,
           "restart_s": restart_s, "death": death[:240]}
    log("[procs] oom " + json.dumps({"card": card, **oom}))
    for a in actors:  # the card's GPU resource goes to the DAG's tasks
        ray_tpu_torch.kill(a)
    return first, oom


def _procs_make_tokens(seed: int, b: int, s: int) -> np.ndarray:
    return np.random.RandomState(seed).randint(0, 50257, (b, s)).astype(np.int64)


def _procs_train(tokens, cfg, steps: int, device: str, count_path: str) -> dict:
    """`steps` fused_adamw steps of a GPT on one batch: the train phase's
    step (attention_impl="flash": K6 forward, K7 backward), the shift taken
    outside the model as the data phase takes it. Returns the losses, the
    f32 parameters on the host and this process's launches; appends a mark
    to `count_path`, which counts its runs. `returned_at` is stamped on the
    host's clock just before the return, whose frame the worker then pickles
    and sends."""
    from ray_tpu_torch.models import cross_entropy_loss
    from ray_tpu_torch.models.gpt import GPT
    from ray_tpu_torch.ops import fused_adamw

    with open(count_path, "a") as f:
        f.write("x")
    t0 = time.perf_counter()
    _own_counts(zero=True)
    model = GPT(cfg, device=device, seed=0)
    params = dict(model.named_parameters())
    opt = fused_adamw(LR)
    state = opt.init(params)
    batch = torch.from_numpy(tokens).to(next(model.parameters()).device)
    losses = []
    for _ in range(steps):
        loss = cross_entropy_loss(model(batch[:, :-1]), batch[:, 1:])
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        _, state = opt.apply(grads, state, params)
        losses.append(loss.item())
    launches = _own_counts()
    host = {k: p.detach().cpu() for k, p in params.items()}
    del model, params, state, grads, loss, batch
    torch.cuda.empty_cache()
    return {"losses": losses, "params": host, "shape": list(tokens.shape),
            "launches": launches, "pid": os.getpid(), "wall_s": time.perf_counter() - t0,
            "returned_at": time.time()}


def _procs_evaluate(trained: dict, cfg, seed: int, device: str, marker) -> dict:
    """The trained parameters' loss on a seeded held-out batch of the train
    batch's shape. Given a `marker` path, the first attempt creates the file
    and fails. `entered_at` is stamped on the host's clock on entry, once the
    trained parameters have arrived and been unpickled."""
    entered_at = time.time()
    if marker is not None and not os.path.exists(marker):
        open(marker, "w").close()
        raise RuntimeError("evaluate fails on its first attempt (marker file)")
    from ray_tpu_torch.models import cross_entropy_loss
    from ray_tpu_torch.models.gpt import GPT

    _own_counts(zero=True)
    model = GPT(cfg, device=device, seed=0)
    with torch.no_grad():
        for k, p in model.named_parameters():
            p.copy_(trained["params"][k])
        x = torch.from_numpy(_procs_make_tokens(seed, *trained["shape"]))
        x = x.to(next(model.parameters()).device)
        loss = cross_entropy_loss(model(x[:, :-1]), x[:, 1:]).item()
    launches = _own_counts()
    del model, x
    torch.cuda.empty_cache()
    return {"loss": loss, "launches": launches, "pid": os.getpid(),
            "train_losses": trained["losses"], "train_launches": trained["launches"],
            "train_pid": trained["pid"], "train_wall_s": trained["wall_s"],
            "train_returned_at": trained["returned_at"], "entered_at": entered_at,
            "params_bytes": sum(t.numel() * t.element_size()
                                for t in trained["params"].values())}


def _procs_dag(device: str, count_path: str, marker):
    """make_tokens (host) -> train (the card) -> evaluate (the card)."""
    import ray_tpu_torch
    from ray_tpu_torch.models.gpt import gpt2_125m

    make = ray_tpu_torch.remote(_procs_make_tokens)
    train = ray_tpu_torch.remote(_procs_train).options(num_gpus=1)
    evaluate = ray_tpu_torch.remote(_procs_evaluate).options(num_gpus=1)
    tokens = make.bind(0, TRAIN_B, TRAIN_S + 1)
    trained = train.bind(tokens, gpt2_125m(), TRAIN_STEPS, device, count_path)
    return evaluate.bind(trained, gpt2_125m(attention_impl="auto"), PROCS_EVAL_SEED,
                         device, marker)


def _procs_run_checks(out: dict, tag: str, layers: int, phase: str = "procs") -> None:
    """A DAG run's train took TRAIN_STEPS steps through K6 and K7 (whose
    wrapper launches K4's and K5's kernels on the packed strides, so their
    counters count as many), with finite losses that fell, and its
    evaluation is finite."""
    per = layers * TRAIN_STEPS
    _want_counts(out["train_launches"], {"K6 flash_fwd_packed": per, "K7 flash_bwd_packed": per,
                                         "K4 flash_bwd_dq": per, "K5 flash_bwd_dkv": per}, phase)
    losses = out["train_losses"]
    if len(losses) != TRAIN_STEPS or not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"[{phase}] {tag} train losses {losses}")
    if not np.isfinite(out["loss"]):
        fail(f"[{phase}] {tag} evaluation loss {out['loss']}")


def _procs_crossing(runtime, out: dict) -> dict:
    """The step result's two crossings of the process boundary in a straight
    DAG run, in seconds on the host's clock. To the driver: from train's
    return in its worker to the driver's FINISHED mark for train, set once
    the frame was pickled, sent, read and sealed in the store. To a worker:
    from the driver's RUNNING mark for evaluate, set at its dispatch, to
    evaluate's first line, once its worker fetched the value by get_by_id in
    one frame and unpickled it."""
    def mark(name: str, state: str) -> float:
        (at,) = [e.state_times[state] for e in runtime.task_events.list_events()
                 if e.name == name and state in e.state_times]
        return at

    return {"to_driver_s": mark("_procs_train", "FINISHED") - out["train_returned_at"],
            "to_worker_s": out["entered_at"] - mark("_procs_evaluate", "RUNNING"),
            "same_worker": out["pid"] == out["train_pid"]}


def _procs_workflow(runtime, card: str, pids: set) -> tuple:
    """The DAG once straight (dag.execute()), then as a workflow whose
    evaluate fails on its first attempt: run() raises, resume() finishes it
    without running train again (its run count stays 1, and the resumed
    children launch no K6 or K7); losses and evaluation bit for bit the
    straight run's."""
    import shutil
    import tempfile

    import ray_tpu_torch
    from ray_tpu_torch import workflow
    from ray_tpu_torch.models.gpt import gpt2_125m
    from ray_tpu_torch.workflow.storage import WorkflowStorage

    layers = gpt2_125m().num_layers
    base = tempfile.mkdtemp(prefix="procs-workflow-")
    try:
        t0 = time.perf_counter()
        straight = ray_tpu_torch.get(
            _procs_dag("cuda", os.path.join(base, "straight.count"), None).execute(),
            timeout=PROCS_TIMEOUT_S)
        straight_s = time.perf_counter() - t0
        _procs_run_checks(straight, "dag", layers)
        _want_counts(straight["launches"], {"K2 flash_fwd": layers})
        pids.update((straight["pid"], straight["train_pid"]))
        dag = {"wall_s": straight_s, "train_losses": straight["train_losses"],
               "eval_loss": straight["loss"], "train_wall_s": straight["train_wall_s"],
               "params_bytes": straight["params_bytes"],
               "crossing": _procs_crossing(runtime, straight),
               "pids": [straight["train_pid"], straight["pid"]],
               "launches": _sum_counts([straight["train_launches"], straight["launches"]])}
        log("[procs] dag " + json.dumps({"card": card, **dag}))

        workflow.init(storage=os.path.join(base, "store"))
        count = os.path.join(base, "workflow.count")
        wdag = _procs_dag("cuda", count, os.path.join(base, "evaluate.failed-once"))
        t0 = time.perf_counter()
        try:
            workflow.run(wdag, workflow_id="procs")
            fail("[procs] the workflow's first run did not fail")
        except RuntimeError as exc:
            first_error = str(exc)
        run_s = time.perf_counter() - t0
        if workflow.get_status("procs") != "RESUMABLE":
            fail(f"[procs] workflow status {workflow.get_status('procs')} after the failure")
        t0 = time.perf_counter()
        resumed = workflow.resume("procs")
        resume_s = time.perf_counter() - t0
        train_runs = len(open(count).read())
        if train_runs != 1 or workflow.get_status("procs") != "SUCCESSFUL":
            fail(f"[procs] train ran {train_runs} times; status "
                 f"{workflow.get_status('procs')}")
        _procs_run_checks(resumed, "workflow", layers)
        _want_counts(resumed["launches"], {"K2 flash_fwd": layers})  # no K6, no K7
        pids.update((resumed["pid"], resumed["train_pid"]))
        same = (resumed["train_losses"] == straight["train_losses"]
                and resumed["loss"] == straight["loss"])
        if not same:
            fail(f"[procs] the workflow's losses {resumed['train_losses']} / "
                 f"{resumed['loss']} differ from the straight run's "
                 f"{straight['train_losses']} / {straight['loss']}")
        store = WorkflowStorage("procs")
        steps = sorted(os.listdir(os.path.join(store.root, "steps")))
        step_bytes = {f: os.path.getsize(os.path.join(store.root, "steps", f)) for f in steps}
        train_step = next(f[:-4] for f in steps if f.endswith("_procs_train.pkl"))
        t0 = time.perf_counter()
        value = store.load_step_result(train_step)
        load_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        WorkflowStorage("procs-save-timing").save_step_result(train_step, value)
        save_s = time.perf_counter() - t0
        del value
        wf = {"first_run_s": run_s, "first_error": first_error[:200], "resume_s": resume_s,
              "train_runs": train_runs, "bit_for_bit_with_dag": same,
              "train_losses": resumed["train_losses"], "eval_loss": resumed["loss"],
              "resumed_launches": resumed["launches"], "step_bytes": step_bytes,
              "train_step_load_s": load_s, "train_step_save_s": save_s,
              "launches": _sum_counts([resumed["train_launches"], resumed["launches"]])}
        log("[procs] workflow " + json.dumps({"card": card, **wf}))
    finally:
        shutil.rmtree(base, ignore_errors=True)
    return dag, wf


def _procs_trainer_loop(config):
    """The trainer phase's loop in a worker process, its counters set to 0
    just before and reported (to the _Tally actor) just after."""
    import ray_tpu_torch

    _own_counts(zero=True)
    try:
        _trainer_loop(config)
    finally:
        tally = ray_tpu_torch.get_actor(config["tally"])
        ray_tpu_torch.get(tally.add.remote(os.getpid(), _own_counts()), timeout=60)


def _procs_trainer(trainer: dict, data: dict, card: str, pids: set) -> dict:
    """The trainer phase's GPT-2 125M loop through TorchTrainer on two
    worker processes at half the card each: K2 and K3 12 a step in each,
    K4-K7 none; step p50 beside the two thread workers of the data phase
    and the trainer phase's one worker."""
    import ray_tpu_torch
    from ray_tpu_torch.models.gpt import gpt2_125m
    from ray_tpu_torch.train import ScalingConfig, TorchBackendConfig, TorchTrainer

    layers = gpt2_125m().num_layers
    tally = ray_tpu_torch.remote(_Tally).options(name=PROCS_TALLY, num_cpus=0).remote()
    fit = TorchTrainer(
        _procs_trainer_loop, train_loop_config={"steps": TRAIN_STEPS, "tally": PROCS_TALLY},
        scaling_config=ScalingConfig(num_workers=DATA_WORKERS,
                                     resources_per_worker={"GPU": PROCS_GPU}),
        backend_config=TorchBackendConfig(device="cuda:0"))
    t0 = time.perf_counter()
    result = fit.fit()
    wall = time.perf_counter() - t0
    if result.error is not None:
        fail(f"[procs] TorchTrainer.fit() failed: {result.error!r}")
    parts = ray_tpu_torch.get(tally.read.remote(), timeout=PROCS_TIMEOUT_S)
    ray_tpu_torch.kill(tally)
    if len(parts) != DATA_WORKERS or os.getpid() in parts:
        fail(f"[procs] trainer worker pids {sorted(parts)}")
    pids.update(parts)
    launches = _sum_counts(parts.values())
    steps = layers * TRAIN_STEPS * DATA_WORKERS
    _want_counts(launches, {"K2 flash_fwd": steps, "K3 flash_bwd_fused": steps})
    history = result.metrics_history
    losses = [m["loss"] for m in history]
    if len(losses) != TRAIN_STEPS or not all(np.isfinite(losses)):
        fail(f"[procs] trainer losses {losses}")
    times = [m["step_s"] for m in history]
    out = {"workers": DATA_WORKERS, "gpu_per_worker": PROCS_GPU, "B": TRAIN_B, "S": TRAIN_S,
           "steps": TRAIN_STEPS, "losses_rank0": losses, "step_s_rank0": times,
           "step_p50_s": statistics.median(times[1:]),
           "data_phase_two_thread_workers_step_p50_s": data["gpt2"]["step_p50_s"],
           "trainer_phase_one_worker_step_p50_s": trainer["step_p50_s"],
           "fit_wall_s": wall, "worker_pids": sorted(parts), "launches": launches,
           "launches_by_pid": parts}
    log("[procs] trainer " + json.dumps({"card": card, **out}))
    return out


def _procs_trainer_threads(card: str, procs: dict) -> dict:
    """The loop of _procs_trainer (the trainer phase's, on one seeded batch
    already on the card) on two thread workers at half the card each, under
    a thread runtime started after the process runtime's teardown: threads
    against processes on the same loop in the same call. The thread workers
    share this process's counters: K2 and K3 12 a step in each worker."""
    import ray_tpu_torch
    from ray_tpu_torch.models.gpt import gpt2_125m
    from ray_tpu_torch.train import ScalingConfig, TorchBackendConfig, TorchTrainer

    layers = gpt2_125m().num_layers
    ray_tpu_torch.init(num_cpus=8, num_gpus=1)
    try:
        fit = TorchTrainer(
            _trainer_loop, train_loop_config={"steps": TRAIN_STEPS},
            scaling_config=ScalingConfig(num_workers=DATA_WORKERS,
                                         resources_per_worker={"GPU": PROCS_GPU}),
            backend_config=TorchBackendConfig(device="cuda:0"))
        _own_counts(zero=True)
        t0 = time.perf_counter()
        result = fit.fit()
        wall = time.perf_counter() - t0
        launches = _own_counts()
    finally:
        ray_tpu_torch.shutdown()
        gc.collect()
        torch.cuda.empty_cache()
    if result.error is not None:
        fail(f"[procs] thread TorchTrainer.fit() failed: {result.error!r}")
    steps = layers * TRAIN_STEPS * DATA_WORKERS
    _want_counts(launches, {"K2 flash_fwd": steps, "K3 flash_bwd_fused": steps})
    history = result.metrics_history
    losses = [m["loss"] for m in history]
    if len(losses) != TRAIN_STEPS or not all(np.isfinite(losses)):
        fail(f"[procs] thread trainer losses {losses}")
    times = [m["step_s"] for m in history]
    p50 = statistics.median(times[1:])
    out = {"workers": DATA_WORKERS, "gpu_per_worker": PROCS_GPU, "steps": TRAIN_STEPS,
           "losses_rank0": losses, "step_s_rank0": times, "step_p50_s": p50,
           "process_workers_step_p50_s": procs["step_p50_s"],
           "process_over_thread": procs["step_p50_s"] / p50,
           "losses_equal_process_rank0": losses == procs["losses_rank0"],
           "fit_wall_s": wall, "launches": launches}
    log("[procs] trainer_threads " + json.dumps({"card": card, **out}))
    return out


def phase_procs(device_info: dict, server: dict, trainer: dict, data: dict) -> dict:
    """GPU actors and tasks in worker processes of their own (phase 18):
    the ActorPool, the OOM kill and restart, the DAG and the workflow, the
    trainer; then no worker alive after shutdown() and the card's used
    memory within LEFT_LIMIT_MIB of its figure at the phase's start; then
    the trainer's loop once more on thread workers, for comparison."""
    import ray_tpu_torch

    t_phase = time.perf_counter()
    card = device_info["smi"]
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    used0 = _device_used()
    runtime = ray_tpu_torch.init(num_cpus=8, num_gpus=1, _system_config={
        "isolation": "process", "memory_monitor_refresh_s": 0.1})
    fraction = _Fraction(0.5)
    runtime.memory_monitor._memory_fraction = fraction
    pids: set = set()
    summary = {}
    try:
        summary["actor_pool"], summary["oom"] = _procs_pool(
            runtime, fraction, server, card, pids)
        summary["dag"], summary["workflow"] = _procs_workflow(runtime, card, pids)
        summary["trainer"] = _procs_trainer(trainer, data, card, pids)
        for engine in list(runtime.engines.values()):
            pids.update(h.proc.pid for h in list(engine._workers))
    finally:
        ray_tpu_torch.shutdown()
    alive = sorted(p for p in pids if _pid_alive(p))
    if alive:
        fail(f"[procs] worker processes alive after shutdown(): {alive}")
    limit = LEFT_LIMIT_MIB * 2**20
    settle_s = _until(lambda: _device_used() <= used0 + limit,
                      f"the card's used memory back within {LEFT_LIMIT_MIB} MiB of "
                      f"{used0 / 2**20:.0f} MiB", deadline_s=30.0)
    summary["teardown"] = {"worker_pids": len(pids), "alive": alive,
                           "device_used_start_mib": used0 / 2**20,
                           "device_used_end_mib": _device_used() / 2**20,
                           "settle_s": settle_s}
    log("[procs] teardown " + json.dumps({"card": card, **summary["teardown"]}))
    summary["trainer_threads"] = _procs_trainer_threads(card, summary["trainer"])
    summary["wall_s"] = time.perf_counter() - t_phase
    log(f"[procs] phase wall {summary['wall_s']:.1f}s")
    summary["paths"] = {
        "procs actor_pool": summary["actor_pool"]["launches"],
        "procs oom restart": summary["oom"]["launches"],
        "procs dag": summary["dag"]["launches"],
        "procs workflow": summary["workflow"]["launches"],
        "procs trainer": summary["trainer"]["launches"],
        "procs trainer threads": summary["trainer_threads"]["launches"],
    }
    return summary


# The store phase (19): the native shared-memory store, spilling and lineage
# recovery under GPT-2 125M. The step result's frame crossings measured by
# phase 18 before the port had a store (PERF.md §6; ~500 MB as a dict of
# tensors, H100 80GB HBM3 at 700 W), printed beside this phase's.
STORE_FRAMES_BEFORE_S = {"to_driver_s": 1.74, "to_worker_s": 1.89}
STORE_SPILL_BUDGET = 3 * 2**29  # 1.5 GiB: three f32 GPT-2 125M state dicts
STORE_SPILL_SEEDS = 5
STORE_REPEAT = 10  # the flat vector 10 times: 4.98 GB, past the u32 frame
STORE_TIMEOUT_S = 300.0


def _mark(runtime, name: str, state: str) -> float:
    """The driver's task-event mark `state` of the one task called `name`."""
    (at,) = [e.state_times[state] for e in runtime.task_events.list_events()
             if e.name == name and state in e.state_times]
    return at


def _store_train(tokens, cfg, steps: int, device: str, count_path: str,
                 on_card: bool):
    """Phase 18's train step, returning GPT's f32 parameters as ONE flat
    tensor (parameters_to_vector, 498 MB: over the native store's
    threshold, where a dict of tensors is not), on the host or on cuda:0.
    The losses, launches and the host-clock stamp taken just before the
    return go to `count_path`.json, as the return carries the vector
    alone."""
    out = _procs_train(tokens, cfg, steps, device, count_path)
    vec = torch.nn.utils.parameters_to_vector(list(out.pop("params").values()))
    if on_card:
        vec = vec.to("cuda")
        torch.cuda.synchronize()
    out["returned_at"] = time.time()
    with open(count_path + ".json", "w") as f:
        json.dump(out, f)
    return vec


def _store_evaluate(vec, cfg, seed: int, shape, device: str) -> dict:
    """Phase 18's evaluate on the flat vector: loaded into a GPT with
    vector_to_parameters, the held-out loss. `entered_at` is stamped on the
    host's clock on entry, once the vector has arrived."""
    entered_at = time.time()
    from ray_tpu_torch.models import cross_entropy_loss
    from ray_tpu_torch.models.gpt import GPT

    arrived = {"device": str(vec.device), "bytes": vec.numel() * vec.element_size()}
    _own_counts(zero=True)
    model = GPT(cfg, device=device, seed=0)
    dev = next(model.parameters()).device
    with torch.no_grad():
        torch.nn.utils.vector_to_parameters(vec.to(dev), model.parameters())
        x = torch.from_numpy(_procs_make_tokens(seed, *shape)).to(dev)
        loss = cross_entropy_loss(model(x[:, :-1]), x[:, 1:]).item()
    launches = _own_counts()
    del model, x, vec
    torch.cuda.empty_cache()
    return {"loss": loss, "launches": launches, "pid": os.getpid(),
            "entered_at": entered_at, "arrived": arrived}


def _store_repeat(vec, times: int, stamp_path: str):
    """A CPU task: the vector `times` over, one tensor past the u32 frame."""
    big = vec.repeat(times)
    with open(stamp_path, "w") as f:
        json.dump({"returned_at": time.time(), "pid": os.getpid()}, f)
    return big


def _store_check_repeat(big, vec, times: int) -> dict:
    """A CPU task: every slice of `big` bit for bit `vec`."""
    entered_at = time.time()
    n = vec.numel()
    ok = big.numel() == n * times and all(
        torch.equal(big[i * n:(i + 1) * n], vec) for i in range(times))
    return {"ok": ok, "entered_at": entered_at, "pid": os.getpid(),
            "bytes": big.numel() * big.element_size()}


def _store_blob(count_path: str) -> dict:
    """A CPU task whose result is freed in (d): its runs are counted."""
    with open(count_path, "a") as f:
        f.write("x")
    return {"blob": torch.zeros(1 << 20)}


def _store_machine(card: str) -> dict:
    """(0) /dev/shm's free bytes, the host's available RAM, the spill
    directory's free disk; (c) needs /dev/shm to hold its 4.98 GB value."""
    import tempfile

    from ray_tpu_torch._private.native_store import shm_free_bytes

    with open("/proc/meminfo") as f:
        avail = next(int(line.split()[1]) * 1024 for line in f
                     if line.startswith("MemAvailable:"))
    st = os.statvfs(tempfile.gettempdir())
    out = {"dev_shm_free_bytes": shm_free_bytes(), "mem_available_bytes": avail,
           "spill_dir": tempfile.gettempdir(),
           "spill_dir_free_bytes": st.f_bavail * st.f_frsize}
    log("[store] machine " + json.dumps({"card": card, **out}))
    if not out["dev_shm_free_bytes"] or out["dev_shm_free_bytes"] < 6 * 10**9:
        fail(f"[store] /dev/shm holds {out['dev_shm_free_bytes']} bytes free: (c)'s "
             "4.98 GB value does not fit (PERF.md §7)")
    return out


def _store_crossing(runtime, variant: str, base: str, on_card: bool) -> dict:
    """(a) train -> evaluate under this runtime, the flat vector between
    them: its two crossings timed as phase 18 times them (task-event marks
    against stamps taken inside the tasks), whether the driver's store
    holds it in shm, then the driver's read of it."""
    import ray_tpu_torch
    from ray_tpu_torch.models.gpt import gpt2_125m

    names = (f"store_train_{variant}", f"store_evaluate_{variant}")
    train = ray_tpu_torch.remote(_store_train).options(num_gpus=1, name=names[0])
    evaluate = ray_tpu_torch.remote(_store_evaluate).options(num_gpus=1, name=names[1])
    tokens = _procs_make_tokens(0, TRAIN_B, TRAIN_S + 1)
    count = os.path.join(base, f"{variant}.count")
    t0 = time.perf_counter()
    ref = train.remote(tokens, gpt2_125m(), TRAIN_STEPS, "cuda", count, on_card)
    ev = ray_tpu_torch.get(evaluate.remote(ref, gpt2_125m(attention_impl="auto"),
                                           PROCS_EVAL_SEED, tokens.shape, "cuda"),
                           timeout=STORE_TIMEOUT_S)
    wall = time.perf_counter() - t0
    with open(count + ".json") as f:
        trained = json.load(f)
    native = runtime._native_store is not None and runtime.store.is_native(ref.id)
    # The driver's read, twice: the first maps the value's pages into this
    # process, the second finds them mapped.
    reads = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        vec = ray_tpu_torch.get(ref, timeout=STORE_TIMEOUT_S)
        torch.cuda.synchronize()
        reads.append(time.perf_counter() - t0)
        if len(reads) == 1:
            first = vec
    if not torch.equal(first, vec):
        fail(f"[store] (a) {variant}: two reads of the vector differ")
    del first
    return {"variant": variant, "ref": ref, "vec": vec, "native": native, "wall_s": wall,
            "train_losses": trained["losses"], "train_launches": trained["launches"],
            "loss": ev["loss"], "launches": ev["launches"], "arrived": ev["arrived"],
            "pids": [trained["pid"], ev["pid"]],
            "crossing": {"to_driver_s": _mark(runtime, names[0], "FINISHED")
                         - trained["returned_at"],
                         "to_worker_s": ev["entered_at"] - _mark(runtime, names[1], "RUNNING"),
                         "driver_read_s": reads[0], "driver_read_again_s": reads[1]}}


def _store_check_crossing(run: dict, procs: dict, card: str, layers: int) -> dict:
    """Phase 18's checks of a DAG run, its losses and evaluation bit for bit
    phase 18's straight DAG, the vector where it should be; the logged line."""
    tag = f"(a) {run['variant']}"
    _procs_run_checks(run, tag, layers, phase="store")
    _want_counts(run["launches"], {"K2 flash_fwd": layers}, "store")
    dag = procs["dag"]
    same = run["train_losses"] == dag["train_losses"] and run["loss"] == dag["eval_loss"]
    if not same:
        fail(f"[store] {tag}: losses {run['train_losses']} / {run['loss']} are not phase "
             f"18's {dag['train_losses']} / {dag['eval_loss']}")
    want_device = "cuda:0" if run["variant"].endswith("card") else "cpu"
    if str(run["vec"].device) != want_device or run["arrived"]["device"] != want_device:
        fail(f"[store] {tag}: the vector is on {run['vec'].device} in the driver and "
             f"{run['arrived']['device']} in evaluate, not {want_device}")
    line = {k: run[k] for k in ("native", "wall_s", "crossing", "pids", "train_losses",
                                "loss")}
    line.update(bytes=run["arrived"]["bytes"], bit_for_bit_with_procs_dag=same,
                frames_before_store_s=STORE_FRAMES_BEFORE_S,
                train_launches=run["train_launches"], evaluate_launches=run["launches"])
    log(f"[store] {tag} " + json.dumps({"card": card, **line}))
    return line


def _store_big(runtime, host_ref, vec, base: str, card: str) -> dict:
    """(c) A CPU worker returns the vector STORE_REPEAT times (4.98 GB); the
    driver gets it and a second worker takes it as an argument, each
    checking every slice bit for bit."""
    import ray_tpu_torch

    names = ("store_repeat", "store_check_repeat")
    repeat = ray_tpu_torch.remote(_store_repeat).options(num_gpus=0, name=names[0],
                                                         max_retries=0)
    check = ray_tpu_torch.remote(_store_check_repeat).options(num_gpus=0, name=names[1],
                                                              max_retries=0)
    stamp = os.path.join(base, "repeat.json")
    t0 = time.perf_counter()
    big_ref = repeat.remote(host_ref, STORE_REPEAT, stamp)
    ray_tpu_torch.wait([big_ref], timeout=STORE_TIMEOUT_S)
    produced_s = time.perf_counter() - t0
    native = runtime.store.is_native(big_ref.id)
    t0 = time.perf_counter()
    big = ray_tpu_torch.get(big_ref, timeout=STORE_TIMEOUT_S)
    read_s = time.perf_counter() - t0
    n = vec.numel()
    driver_ok = big.numel() == n * STORE_REPEAT and all(
        torch.equal(big[i * n:(i + 1) * n], vec) for i in range(STORE_REPEAT))
    nbytes = big.numel() * big.element_size()
    del big
    checked = ray_tpu_torch.get(check.remote(big_ref, host_ref, STORE_REPEAT),
                                timeout=STORE_TIMEOUT_S)
    with open(stamp) as f:
        returned_at = json.load(f)["returned_at"]
    out = {"bytes": nbytes, "native": native, "produced_s": produced_s,
           "driver_ok": driver_ok, "worker_ok": checked["ok"],
           "crossing": {"to_driver_s": _mark(runtime, names[0], "FINISHED") - returned_at,
                        "driver_read_s": read_s,
                        "to_worker_s": checked["entered_at"]
                        - _mark(runtime, names[1], "RUNNING")}}
    del big_ref
    log("[store] (c) " + json.dumps({"card": card, **out}))
    if nbytes < 1 << 32 or not (native and driver_ok and checked["ok"]):
        fail(f"[store] (c) the {nbytes}-byte value: in shm {native}, intact in the "
             f"driver {driver_ok}, in the worker {checked['ok']}")
    return out


def _store_frames_refuse_big(host_ref) -> str:
    """(c) with the store off: the same task fails with FrameTooLargeError."""
    import ray_tpu_torch
    from ray_tpu_torch._private import wire

    repeat = ray_tpu_torch.remote(_store_repeat).options(num_gpus=0, max_retries=0)
    try:
        ray_tpu_torch.get(repeat.remote(host_ref, STORE_REPEAT, os.devnull),
                          timeout=STORE_TIMEOUT_S)
    except wire.FrameTooLargeError as exc:
        return str(exc)[:200]
    except Exception as exc:  # noqa: BLE001 - reported as the wrong failure
        fail(f"[store] (c) with the store off the value failed with {exc!r}, not "
             "FrameTooLargeError")
    fail("[store] (c) with the store off a value past the u32 frame crossed")


def _store_processes(procs: dict, card: str, pids: set) -> dict:
    """(a) and (c): a process runtime with the store on (host and card
    vectors, the 4.98 GB value), then one with it off (the frame path's
    crossings of the same vector, and the 4.98 GB value refused)."""
    import shutil
    import tempfile

    import ray_tpu_torch
    from ray_tpu_torch.models.gpt import gpt2_125m

    layers = gpt2_125m().num_layers
    base = tempfile.mkdtemp(prefix="store-phase-")
    out = {}
    try:
        runtime = ray_tpu_torch.init(num_cpus=8, num_gpus=1,
                                     _system_config={"isolation": "process"})
        try:
            host = _store_crossing(runtime, "shm_host", base, on_card=False)
            out["shm_host"] = _store_check_crossing(host, procs, card, layers)
            if not host["native"]:
                fail("[store] (a) the 498 MB vector is not in shm (is_native false)")
            on_card = _store_crossing(runtime, "shm_card", base, on_card=True)
            out["shm_card"] = _store_check_crossing(on_card, procs, card, layers)
            if not on_card["native"]:
                fail("[store] (a) the 498 MB cuda:0 vector is not in shm")
            if not torch.equal(on_card["vec"].cpu(), host["vec"]):
                fail("[store] (a) the card's vector differs from the host's")
            # The vector onto the card: read out of the segment straight to
            # cuda:0 (get of the card variant above: one host-to-device copy
            # from the pageable segment) and from the driver's private copy.
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dev = host["vec"].to("cuda")
            torch.cuda.synchronize()
            out["h2d"] = {"segment_to_card_s": on_card["crossing"]["driver_read_s"],
                          "private_to_card_s": time.perf_counter() - t0,
                          "segment_to_host_s": host["crossing"]["driver_read_s"],
                          "bytes": dev.numel() * dev.element_size()}
            del dev, on_card["vec"]
            log("[store] (a) host-to-device " + json.dumps({"card": card, **out["h2d"]}))
            out["big"] = _store_big(runtime, host["ref"], host["vec"], base, card)
            out["shm_vec"] = host.pop("vec")
            del host, on_card
            for engine in list(runtime.engines.values()):
                pids.update(h.proc.pid for h in list(engine._workers))
        finally:
            ray_tpu_torch.shutdown()
        runtime = ray_tpu_torch.init(num_cpus=8, num_gpus=1, _system_config={
            "isolation": "process", "native_store_enabled": False})
        try:
            frames = _store_crossing(runtime, "frames_host", base, on_card=False)
            out["frames_host"] = _store_check_crossing(frames, procs, card, layers)
            if frames["native"]:
                fail("[store] (a) a vector is in shm with the store off")
            if not torch.equal(frames["vec"], out["shm_vec"]):
                fail("[store] (a) the frame path's vector differs from the shm path's")
            out["frames_refuse_big"] = _store_frames_refuse_big(frames["ref"])
            log("[store] (c) store off: " + out["frames_refuse_big"])
            del frames
            for engine in list(runtime.engines.values()):
                pids.update(h.proc.pid for h in list(engine._workers))
        finally:
            ray_tpu_torch.shutdown()
    finally:
        shutil.rmtree(base, ignore_errors=True)
    return out


def _store_timed(obj, name: str, sink: list) -> None:
    """Wrap obj.name (an instance attribute) to append each call's seconds."""
    fn = getattr(obj, name)

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            sink.append(time.perf_counter() - t0)

    setattr(obj, name, timed)


def _store_spill(runtime, server: dict, card: str) -> tuple:
    """(b) five f32 GPT-2 125M state dicts under a 1.5 GiB store: the oldest
    spill, each reads back bit for bit, and the spilled seed-0 dict serves
    the server phase's prompts token for token (K1 and K2 counted)."""
    import ray_tpu_torch
    from ray_tpu_torch.llm import LLMServer
    from ray_tpu_torch.models.gpt import GPT, gpt2_125m
    from ray_tpu_torch.ops.flash_attention import flash_attention_fwd
    from ray_tpu_torch.ops.paged_flash import paged_flash_attention

    storage = runtime._spill_storage
    spills, restores = [], []
    _store_timed(storage, "spill", spills)
    _store_timed(storage, "restore", restores)
    dicts = [GPT(gpt2_125m(), device="cpu", seed=s).state_dict()
             for s in range(STORE_SPILL_SEEDS)]
    refs, put_s = [], []
    for sd in dicts:
        t0 = time.perf_counter()
        refs.append(ray_tpu_torch.put(sd))
        put_s.append(time.perf_counter() - t0)
    spilled = [i for i, r in enumerate(refs)
               if runtime.store._entries[r.id].spilled_uri is not None]
    stats = storage.stats()
    dict_bytes = sum(t.numel() * t.element_size() for t in dicts[0].values())
    if spilled[:2] != [0, 1] or stats["num_spilled"] < 2 \
            or stats["spilled_bytes"] < 2 * dict_bytes:
        fail(f"[store] (b) spilled {spilled}, stats {stats}: the oldest two must spill")
    same = []
    read_s = []
    for sd, ref in zip(dicts, refs):
        t0 = time.perf_counter()
        got = ray_tpu_torch.get(ref, timeout=STORE_TIMEOUT_S)
        read_s.append(time.perf_counter() - t0)
        same.append(list(got) == list(sd) and all(torch.equal(got[k], sd[k]) for k in sd))
    if not all(same):
        fail(f"[store] (b) dicts read back bit for bit: {same}")
    got0 = ray_tpu_torch.get(refs[0], timeout=STORE_TIMEOUT_S)  # from its spill file
    serving = LLMServer(gpt2_125m(), _engine_config(), params=got0)
    del got0
    serving.reset_prefix_cache()
    prompts = _prompts(np.random.RandomState(0))
    paged_flash_attention.launches = 0
    flash_attention_fwd.launches = 0
    tokens = _sequential(serving, prompts, 32)
    launches = {"K1 paged_attention": paged_flash_attention.launches,
                "K2 flash_fwd": flash_attention_fwd.launches}
    _free(serving)
    identical = tokens == server["bf16_sequential_tokens"]
    out = {"put_s": put_s, "read_s": read_s, "spilled_seeds": spilled, "stats": storage.stats(),
           "spill_s": spills, "restore_s": restores, "dict_bytes": dict_bytes,
           "bit_for_bit": all(same), "served_token_identical": identical,
           "launches": launches}
    log("[store] (b) " + json.dumps({"card": card, **out}))
    if not identical:
        fail("[store] (b) the spilled checkpoint's tokens differ from the server phase's")
    for name, n in launches.items():
        if n <= 0:
            fail(f"[store] (b) {name} was not launched serving the spilled checkpoint")
    return out, refs, dicts


def _store_recovery(runtime, refs: list, dicts: list, card: str) -> dict:
    """(d) train (num_gpus=1, K6 + K7) returns its state dict; pressure
    spills it and a put dict; both spill files are deleted. `get` re-runs
    train exactly once, bit for bit, K6/K7 counted in that run; the put
    object raises ObjectLostError and a freed task result ObjectFreedError,
    re-running nothing."""
    import tempfile

    import ray_tpu_torch
    from ray_tpu_torch.exceptions import ObjectFreedError, ObjectLostError
    from ray_tpu_torch.models.gpt import gpt2_125m

    store = runtime.store
    store.free([r.id for r in refs])  # (b)'s dicts: their spill files go too
    base = tempfile.mkdtemp(prefix="store-recovery-")
    count, blob_count = os.path.join(base, "train.count"), os.path.join(base, "blob.count")
    train = ray_tpu_torch.remote(_procs_train).options(num_gpus=1, name="store_recovery_train")
    blob = ray_tpu_torch.remote(_store_blob).options(num_gpus=0)
    tokens = _procs_make_tokens(0, TRAIN_B, TRAIN_S + 1)
    t_ref = train.remote(tokens, gpt2_125m(), TRAIN_STEPS, "cuda", count)
    first = ray_tpu_torch.get(t_ref, timeout=STORE_TIMEOUT_S)
    p_ref = ray_tpu_torch.put(dicts[0])
    f_ref = blob.remote(blob_count)
    ray_tpu_torch.get(f_ref, timeout=STORE_TIMEOUT_S)
    ballast = [ray_tpu_torch.put(d) for d in dicts[1:4]]
    uris = {name: store._entries[r.id].spilled_uri for name, r in
            (("train", t_ref), ("put", p_ref))}
    if None in uris.values():
        fail(f"[store] (d) pressure did not spill train's result and the put dict: {uris}")
    for uri in uris.values():
        os.remove(uri)
    store.free([f_ref.id])
    _own_counts(zero=True)
    t0 = time.perf_counter()
    again = ray_tpu_torch.get(t_ref, timeout=STORE_TIMEOUT_S)
    recover_s = time.perf_counter() - t0
    launches = _own_counts()
    runs = len(open(count).read())
    same = (again["losses"] == first["losses"] and list(again["params"]) == list(first["params"])
            and all(torch.equal(again["params"][k], v) for k, v in first["params"].items()))
    errors = {}
    for name, ref, want in (("put", p_ref, ObjectLostError), ("freed", f_ref, ObjectFreedError)):
        try:
            ray_tpu_torch.get(ref, timeout=STORE_TIMEOUT_S)
            errors[name] = "no error"
        except want as exc:
            errors[name] = type(exc).__name__
        except Exception as exc:  # noqa: BLE001 - reported as the wrong error
            errors[name] = f"{type(exc).__name__} (want {want.__name__})"
    blob_runs = len(open(blob_count).read())
    runs_after = len(open(count).read())
    del ballast, again, first
    out = {"train_runs": runs, "train_runs_after_errors": runs_after, "blob_runs": blob_runs,
           "recover_s": recover_s, "bit_for_bit": same, "errors": errors,
           "launches": launches, "stats": runtime._spill_storage.stats()}
    log("[store] (d) " + json.dumps({"card": card, **out}))
    layers = gpt2_125m().num_layers
    per = layers * TRAIN_STEPS
    _want_counts(launches, {"K6 flash_fwd_packed": per, "K7 flash_bwd_packed": per,
                            "K4 flash_bwd_dq": per, "K5 flash_bwd_dkv": per}, "store")
    if runs != 2 or runs_after != 2 or blob_runs != 1 or not same \
            or errors != {"put": "ObjectLostError", "freed": "ObjectFreedError"}:
        fail(f"[store] (d) train ran {runs} then {runs_after} times, the blob {blob_runs}; "
             f"bit for bit {same}; errors {errors}")
    import shutil

    shutil.rmtree(base, ignore_errors=True)
    return out


def phase_store(device_info: dict, server: dict, procs: dict) -> dict:
    """The native shared-memory store, spilling and lineage recovery
    (phase 19): (0) the machine; (a) and (c) under worker processes; (b)
    and (d) under a thread runtime with a 1.5 GiB store; (e) no segment,
    spill directory or worker left, and the card's memory back."""
    import glob

    import ray_tpu_torch

    t_phase = time.perf_counter()
    card = device_info["smi"]
    summary = {"machine": _store_machine(card)}
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    used0, mem0 = _device_used(), torch.cuda.memory_allocated()
    pids: set = set()
    summary.update(_store_processes(procs, card, pids))
    runtime = ray_tpu_torch.init(num_cpus=8, num_gpus=1, _system_config={
        "object_store_memory": STORE_SPILL_BUDGET})
    spill_dir = runtime._spill_storage.directory
    segment = "/dev/shm" + runtime._native_store.name.decode()
    try:
        summary["spill"], refs, dicts = _store_spill(runtime, server, card)
        summary["recovery"] = _store_recovery(runtime, refs, dicts, card)
        del refs, dicts
    finally:
        ray_tpu_torch.shutdown()
    alive = sorted(p for p in pids if _pid_alive(p))
    left = {"segments": sorted(glob.glob("/dev/shm/ray_tpu_torch_*")),
            "spill_dir_exists": os.path.exists(spill_dir), "segment": segment,
            "worker_pids": len(pids), "alive": alive}
    if left["segments"] or left["spill_dir_exists"] or alive:
        fail(f"[store] after shutdown(): {left}")
    left["left_allocated_mib"] = _settle(mem0, "store")
    limit = LEFT_LIMIT_MIB * 2**20
    left["settle_s"] = _until(lambda: _device_used() <= used0 + limit,
                              f"the card's used memory back within {LEFT_LIMIT_MIB} MiB of "
                              f"{used0 / 2**20:.0f} MiB", deadline_s=30.0)
    left.update(device_used_start_mib=used0 / 2**20, device_used_end_mib=_device_used() / 2**20)
    summary["teardown"] = left
    log("[store] (e) teardown " + json.dumps({"card": card, **left}))
    summary["wall_s"] = time.perf_counter() - t_phase
    log(f"[store] phase wall {summary['wall_s']:.1f}s")
    # (a)'s host vector, which phase 20's crossings must give bit for bit.
    summary["vec"] = summary.pop("shm_vec")
    shm = ("shm_host", "shm_card")
    summary["paths"] = {
        "store train": _sum_counts([summary[v]["train_launches"] for v in shm]),
        "store evaluate": _sum_counts([summary[v]["evaluate_launches"] for v in shm]),
        "store spilled serve": summary["spill"]["launches"],
        "store recovery": summary["recovery"]["launches"],
    }
    return summary


# The nodes phase (20): GCS persistence and remote nodes. A head with no GPU
# of its own, node daemons that joined it over TCP with the card as their
# GPU, GPT-2 125M served and trained under them, its 498 MB parameter vector
# pulled across the object plane, a remote driver, a node's death, and a
# head SIGKILLed and restarted from its snapshot.
NODES_GPU = 0.5
NODES_STORE_BYTES = 2 << 30  # each daemon's store, given explicitly (§D25, §D27)
NODES_TIMEOUT_S = 300.0
NODES_RECONNECT_S = 90
NODES_TOKEN = "nodes-restart"
NODES_KV = (b"nodes-kv", b"\x00gpt2-125m\xff" * 4)
NODES_N_NEW = 32
_ROOT = os.path.dirname(os.path.abspath(__file__))


class _Lines:
    """A child's merged stdout/stderr, read on a thread: every line with
    its arrival time on this host's clock (perf_counter), echoed with the
    child's tag."""

    def __init__(self, proc, tag: str, phase: str = "nodes"):
        self.proc, self.tag, self.phase = proc, tag, phase
        self.lines: list = []
        self._cond = threading.Condition()
        threading.Thread(target=self._pump, daemon=True).start()

    def _pump(self) -> None:
        for line in self.proc.stdout:
            line = line.rstrip("\n")
            log(f"[{self.phase}] ({self.tag}) {line}")
            with self._cond:
                self.lines.append((line, time.perf_counter()))
                self._cond.notify_all()

    def wait(self, prefix: str, timeout: float = NODES_TIMEOUT_S, after: int = 0) -> tuple:
        """(line, arrival time) of the first line from index `after` on that
        starts with `prefix`; fails after `timeout` or when the child exits
        without printing it."""
        deadline = time.perf_counter() + timeout
        with self._cond:
            while True:
                for line, at in self.lines[after:]:
                    if line.startswith(prefix):
                        return line, at
                left = deadline - time.perf_counter()
                if left <= 0 or (self.proc.poll() is not None and left < timeout - 2):
                    fail(f"[{self.phase}] ({self.tag}) no {prefix!r} line (exit code "
                         f"{self.proc.poll()})")
                self._cond.wait(timeout=min(left, 0.5))

    def event(self, kind: str, timeout: float = NODES_TIMEOUT_S) -> dict:
        """The JSON of a `NODES <kind> {...}` line of a head process."""
        line, at = self.wait(f"NODES {kind} ", timeout)
        return {**json.loads(line.split(" ", 2)[2]), "at": at}


def _nodes_env() -> dict:
    """Children start from the checkout: the package and this script import
    from its root."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (_ROOT, env.get("PYTHONPATH")) if p)
    return env


def _nodes_daemon(address: str, tag: str, extra=()) -> dict:
    """`python -m ray_tpu_torch._private.node_daemon` with the card as one
    GPU, a custom resource `tag` and an explicit store size."""
    cmd = [sys.executable, "-m", "ray_tpu_torch._private.node_daemon",
           "--address", address, "--num-cpus", "4", "--num-gpus", "1",
           "--resources", json.dumps({tag: 1}),
           "--object-store-memory", str(NODES_STORE_BYTES), *extra]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=_ROOT, env=_nodes_env(), text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    return {"tag": tag, "proc": proc, "lines": _Lines(proc, tag), "t0": t0}


def _nodes_child(tag: str, entry: str, args=()) -> dict:
    """`python3 -c 'import chip_smoke; chip_smoke.<entry>(...)'` from the
    repository root, started at the phase's start: it imports torch and
    the package while the phase goes on, then waits for its arguments on a
    line of its stdin (`_nodes_go`)."""
    code = ("import sys, chip_smoke; args = sys.argv[1:] + sys.stdin.readline().split(); "
            f"sys.exit(chip_smoke.{entry}(args))")
    proc = subprocess.Popen([sys.executable, "-c", code, *args], cwd=_ROOT,
                            env=_nodes_env(), text=True, stdin=subprocess.PIPE,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    return {"proc": proc, "lines": _Lines(proc, tag), "t0": time.perf_counter()}


def _nodes_go(child: dict, *args) -> None:
    child["proc"].stdin.write(" ".join(map(str, args)) + "\n")
    child["proc"].stdin.flush()
    child["t0"] = time.perf_counter()


def _nodes_fixed_port() -> int:
    """A free TCP port below the kernel's ephemeral range (32768 and up by
    default), for (d)'s fixed port: no port-0 bind meanwhile can take it
    before head 1 binds it."""
    import random
    import socket

    for port in random.Random(os.getpid()).sample(range(20000, 32000), 200):
        with socket.socket() as sock:
            try:
                sock.bind(("127.0.0.1", port))
            except OSError:
                continue
        return port
    fail("[nodes] no free port in 20000-32000")


def _ppid(pid: int) -> int:
    with open(f"/proc/{pid}/stat") as f:
        return int(f.read().rsplit(")", 1)[1].split()[1])


def _sha256(t) -> str:
    import hashlib

    return hashlib.sha256(memoryview(t.detach().cpu().contiguous().numpy())).hexdigest()


def _serve_prompts(actor, prompts, n_new) -> tuple:
    """The prompts through one server actor, each alone from an empty prefix
    cache, its counters set to 0 just before and read just after: (tokens,
    launches, wall seconds)."""
    import ray_tpu_torch

    ray_tpu_torch.get(actor.zero.remote(), timeout=NODES_TIMEOUT_S)
    t0 = time.perf_counter()
    tokens = [ray_tpu_torch.get(actor.generate.remote(i, p, n_new),
                                timeout=NODES_TIMEOUT_S)[1]
              for i, p in enumerate(prompts)]
    wall = time.perf_counter() - t0
    return tokens, ray_tpu_torch.get(actor.counts.remote(), timeout=NODES_TIMEOUT_S), wall


def _nodes_tokens_ok(tokens, want, launches, tag: str, phase: str = "nodes") -> None:
    if tokens != want:
        bad = [i for i, (g, w) in enumerate(zip(tokens, want)) if g != w]
        fail(f"[{phase}] {tag}: prompts {bad} differ from the server phase's tokens")
    for name in ("K1 paged_attention", "K2 flash_fwd"):
        if launches[name] <= 0:
            fail(f"[{phase}] {tag}: {name} was not launched in the actor: {launches}")


def _nodes_head(argv) -> int:
    """(d)'s head, run as `python3 -c 'import chip_smoke; ...' first|second
    PORT TOKEN GCS_PATH` from the repository root (`_nodes_child`; head 1
    gets its arguments at the phase's start and waits for its daemon
    through (a)-(c), head 2 when head 1 is gone). `first`: a head with no
    GPU and GCS persistence on, a KV entry, a detached GPT-2 125M server
    (`gpt2`, built from seed 0 in its actor) on the daemon that joins, the
    8 prompts served, the snapshot saved; then it waits to be SIGKILLed.
    `second`: the same port, token and snapshot; the daemon rejoins, the
    restored actor serves the prompts; then shutdown(). Each step prints a
    `NODES <event> {json}` line."""
    import ray_tpu_torch
    from ray_tpu_torch._private.gcs_storage import build_snapshot
    from ray_tpu_torch.models.gpt import gpt2_125m

    which, port, token, gcs = argv[0], int(argv[1]), argv[2], argv[3]

    def emit(kind: str, **body) -> None:
        print(f"NODES {kind} " + json.dumps(body), flush=True)

    t0 = time.perf_counter()
    runtime = ray_tpu_torch.init(num_cpus=1, num_gpus=0, _system_config={
        "isolation": "process", "gcs_storage_path": gcs})
    runtime.serve_clients(port=port, token=token)
    kv = runtime.controller.kv_get(NODES_KV[0])
    emit("listening", init_s=time.perf_counter() - t0, pid=os.getpid(),
         job=runtime.job_id.to_int(), kv=kv.hex() if kv is not None else None)
    while len(runtime.controller.alive_nodes()) < 2:
        if time.perf_counter() - t0 > 2 * NODES_TIMEOUT_S:
            emit("failed", what="no daemon joined")
            return 1
        time.sleep(0.02)
    emit("joined", since_init_s=time.perf_counter() - t0)
    prompts = _prompts(np.random.RandomState(0))
    if which == "first":
        runtime.controller.kv_put(*NODES_KV)
        ray_tpu_torch.remote(_GPTServerActor).options(
            name="gpt2", lifetime="detached", num_gpus=NODES_GPU,
            resources={"nodeR": 0.1}).remote(gpt2_125m(), _engine_config(), "cuda")
    actor = ray_tpu_torch.get_actor("gpt2")  # restored at init() in `second`
    info = ray_tpu_torch.get(actor.info.remote(), timeout=NODES_TIMEOUT_S)
    first_token_s = None
    if which == "second":
        ray_tpu_torch.get(actor.generate.remote(0, prompts[0], 1), timeout=NODES_TIMEOUT_S)
        first_token_s = time.perf_counter() - t0
    tokens, launches, wall = _serve_prompts(actor, prompts, NODES_N_NEW)
    emit("served", info=info, tokens=tokens, launches=launches, wall_s=wall,
         init_to_first_token_s=first_token_s)
    if which == "first":
        t1 = time.perf_counter()
        snapshot = build_snapshot(runtime)
        t2 = time.perf_counter()
        runtime._gcs_storage.save(snapshot)
        t3 = time.perf_counter()
        emit("saved", bytes=os.path.getsize(gcs), build_s=t2 - t1, save_s=t3 - t2,
             detached=len(snapshot["detached_actors"]))
        time.sleep(3600)  # SIGKILLed here
        return 1
    ray_tpu_torch.shutdown()
    emit("down")
    return 0


def _nodes_warm() -> dict:
    """A task that imports torch, leaving a worker in its node's pool."""
    t0 = time.perf_counter()
    import torch as _torch  # noqa: F401

    return {"pid": os.getpid(), "torch_import_s": time.perf_counter() - t0}


def _nodes_shout(marker: str) -> int:
    """A line on a daemon worker's stdout, for the remote driver to see."""
    print(marker, flush=True)
    return os.getpid()


def _nodes_client(argv) -> int:
    """(b)'s remote driver, run as `python3 -c 'import chip_smoke; ...'`
    with ADDRESS OID_HEX PROMPTS_JSON on its stdin (`_nodes_child`):
    ray_tpu_torch.init(address=...) and no
    runtime of its own; the server actor found by name serves the prompts;
    a task on nodeA prints a marker whose line the head pushes here; the
    vector read by its id. Prints `NODES client {json}`."""
    import ray_tpu_torch
    from ray_tpu_torch._private import log_aggregation
    from ray_tpu_torch._private.ids import ObjectID
    from ray_tpu_torch._private.object_ref import ObjectRef

    address, oid_hex, prompts_path = argv
    with open(prompts_path) as f:
        prompts = json.load(f)
    marker = f"nodes client marker {os.getpid()}"
    seen: dict = {}
    pushed = threading.Event()
    reprint = log_aggregation.print_batch_to_driver

    def watch(batch, file=None):
        reprint(batch, file)
        if marker in batch["lines"]:
            seen.update(pid=batch["pid"], node=batch["hostname"])
            pushed.set()

    log_aggregation.print_batch_to_driver = watch
    t0 = time.perf_counter()
    ray_tpu_torch.init(address=address)
    connect_s = time.perf_counter() - t0
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "ray_tpu"))
    actor = ray_tpu_torch.get_actor("nodes_gpt2")
    tokens, launches, wall = _serve_prompts(actor, prompts, NODES_N_NEW)
    shout = ray_tpu_torch.remote(_nodes_shout).options(resources={"nodeA": 0.1})
    shout_pid = ray_tpu_torch.get(shout.remote(marker), timeout=NODES_TIMEOUT_S)
    log_seen = pushed.wait(30.0)
    ref = ObjectRef(ObjectID.from_hex(oid_hex))
    t1 = time.perf_counter()
    vec = ray_tpu_torch.get(ref, timeout=NODES_TIMEOUT_S)
    read_s = time.perf_counter() - t1
    out = {"connect_s": connect_s, "tokens": tokens, "launches": launches, "wall_s": wall,
           "log_seen": log_seen, "log": {**seen, "shout_pid": shout_pid},
           "read_s": read_s, "device": str(vec.device), "sha256": _sha256(vec),
           "bytes": vec.numel() * vec.element_size(), "pid": os.getpid(),
           "leaked_modules": leaked}
    del vec, ref
    ray_tpu_torch.shutdown()
    print("NODES client " + json.dumps(out), flush=True)
    return 0


def _nodes_start(runtime, address: str, daemons: list, card: str) -> dict:
    """nodeA and nodeB started together; each one's start (its `node daemon
    up` line, printed once the head welcomed it) and registration (the head
    lists it) seconds."""
    for tag in ("nodeA", "nodeB"):
        daemons.append(_nodes_daemon(address, tag))
    out = {}
    for d in daemons:
        _, at = d["lines"].wait("node daemon up")
        out[d["tag"]] = {"pid": d["proc"].pid, "up_s": at - d["t0"]}
    t_reg = _until(lambda: len(runtime.controller.alive_nodes()) == 3,
                   "both daemons registered", NODES_TIMEOUT_S, phase="nodes")
    for d in daemons:
        out[d["tag"]]["registered_s"] = time.perf_counter() - d["t0"]
        d["node_id"] = next(n.node_id for n in runtime.controller.alive_nodes()
                            if d["tag"] in n.total)
    out["wait_after_start_s"] = t_reg
    log("[nodes] daemons " + json.dumps({"card": card, **out}))
    return out


def _nodes_serve(prompts, want, daemons, pids: set, card: str) -> tuple:
    """(a) A GPT-2 125M server actor at NODES_GPU on nodeA, named for (b)."""
    import ray_tpu_torch
    from ray_tpu_torch.models.gpt import gpt2_125m

    t0 = time.perf_counter()
    actor = ray_tpu_torch.remote(_GPTServerActor).options(
        name="nodes_gpt2", num_gpus=NODES_GPU, resources={"nodeA": 0.1}).remote(
            gpt2_125m(), _engine_config(), "cuda")
    info = ray_tpu_torch.get(actor.info.remote(), timeout=NODES_TIMEOUT_S)
    up_s = time.perf_counter() - t0
    pids.add(info["pid"])
    if info["ppid"] != daemons[0]["proc"].pid:
        fail(f"[nodes] (a) the server actor's parent is {info['ppid']}, not nodeA's "
             f"daemon {daemons[0]['proc'].pid}")
    tokens, launches, wall = _serve_prompts(actor, prompts, NODES_N_NEW)
    _nodes_tokens_ok(tokens, want, launches, "(a) server on nodeA")
    out = {"actor": info, "up_s": up_s, "wall_s": wall, "token_identical": True,
           "tokens_per_s": NODES_N_NEW * len(prompts) / wall, "launches": launches}
    log("[nodes] (a) serve " + json.dumps({"card": card, **out}))
    return actor, out


def _nodes_cross(runtime, daemons, procs: dict, stored: dict, base: str, pids: set,
                 card: str, layers: int, on_card: bool) -> dict:
    """(a) train on nodeB returns the flat vector (on the host or cuda:0);
    evaluate on nodeA takes its ref, so nodeA's daemon pulls the bytes from
    nodeB's object server into its store over loopback TCP; then the
    driver's get pulls them to the head. Losses and evaluation bit for bit
    phase 18's straight DAG, the vector bit for bit phase 19's."""
    import ray_tpu_torch
    from ray_tpu_torch.models.gpt import gpt2_125m

    variant = "card" if on_card else "host"
    names = (f"nodes_train_{variant}", f"nodes_evaluate_{variant}")
    train = ray_tpu_torch.remote(_store_train).options(
        num_gpus=NODES_GPU, resources={"nodeB": 0.1}, name=names[0])
    evaluate = ray_tpu_torch.remote(_store_evaluate).options(
        num_gpus=NODES_GPU, resources={"nodeA": 0.1}, name=names[1])
    tokens = _procs_make_tokens(0, TRAIN_B, TRAIN_S + 1)
    count = os.path.join(base, f"{variant}.count")
    t0 = time.perf_counter()
    ref = train.remote(tokens, gpt2_125m(), TRAIN_STEPS, "cuda", count, on_card)
    ev = ray_tpu_torch.get(evaluate.remote(ref, gpt2_125m(attention_impl="auto"),
                                           PROCS_EVAL_SEED, tokens.shape, "cuda"),
                           timeout=NODES_TIMEOUT_S)
    wall = time.perf_counter() - t0
    with open(count + ".json") as f:
        trained = json.load(f)
    located = runtime.store.location_of(ref.id)
    holders = runtime.store.locations_of(ref.id)
    reads = []
    for _ in range(2):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        vec = ray_tpu_torch.get(ref, timeout=NODES_TIMEOUT_S)
        torch.cuda.synchronize()
        reads.append(time.perf_counter() - t1)
    pids.update((trained["pid"], ev["pid"]))
    parents = {"train": _ppid(trained["pid"]), "evaluate": _ppid(ev["pid"])}
    run = {"train_launches": trained["launches"], "train_losses": trained["losses"],
           "loss": ev["loss"], "launches": ev["launches"]}
    _procs_run_checks(run, f"(a) {variant}", layers, phase="nodes")
    _want_counts(ev["launches"], {"K2 flash_fwd": layers}, "nodes")
    dag = procs["dag"]
    same_dag = trained["losses"] == dag["train_losses"] and ev["loss"] == dag["eval_loss"]
    want_device = "cuda:0" if on_card else "cpu"
    same_vec = torch.equal(vec.cpu(), stored["vec"])
    shm = stored["shm_host"]["crossing"]
    out = {"variant": variant, "wall_s": wall, "pids": [trained["pid"], ev["pid"]],
           "parents": parents, "bytes": ev["arrived"]["bytes"],
           "arrived": ev["arrived"]["device"], "driver_device": str(vec.device),
           "located_on_nodeB": located == daemons[1]["node_id"],
           "holders": len(holders),
           "crossing": {"to_nodeB_store_s": _mark(runtime, names[0], "FINISHED")
                        - trained["returned_at"],
                        "nodeB_to_nodeA_s": ev["entered_at"]
                        - _mark(runtime, names[1], "RUNNING"),
                        "to_head_s": reads[0], "head_read_again_s": reads[1]},
           "phase19_same_node_s": {"to_driver_s": shm["to_driver_s"],
                                   "to_worker_s": shm["to_worker_s"],
                                   "driver_read_s": shm["driver_read_s"]},
           "train_losses": trained["losses"], "loss": ev["loss"],
           "bit_for_bit_with_procs_dag": same_dag, "vector_bit_for_bit_phase19": same_vec,
           "train_launches": trained["launches"], "evaluate_launches": ev["launches"]}
    log(f"[nodes] (a) cross {variant} " + json.dumps({"card": card, **out}))
    if (parents["train"] != daemons[1]["proc"].pid
            or parents["evaluate"] != daemons[0]["proc"].pid):
        fail(f"[nodes] (a) {variant}: train under {parents['train']}, evaluate under "
             f"{parents['evaluate']}, not nodeB's and nodeA's daemons")
    if not (same_dag and same_vec and out["located_on_nodeB"]):
        fail(f"[nodes] (a) {variant}: losses as phase 18's {same_dag}, vector as phase "
             f"19's {same_vec}, located on nodeB {out['located_on_nodeB']}")
    if out["arrived"] != want_device or out["driver_device"] != want_device:
        fail(f"[nodes] (a) {variant}: the vector is on {out['arrived']} in evaluate and "
             f"{out['driver_device']} in the driver, not {want_device}")
    out["ref"] = ref
    del vec
    return out


def _nodes_remote_driver(runtime, client: dict, address: str, prompts, want, ref,
                         stored: dict, base: str, card: str) -> dict:
    """(b) The child process (`_nodes_client`) connects with
    init(address=...), serves the prompts through the named actor, sees a
    daemon worker's line, reads the vector; after it exits the head holds
    none of its borrows."""
    prompts_path = os.path.join(base, "prompts.json")
    with open(prompts_path, "w") as f:
        json.dump([list(map(int, p)) for p in prompts], f)
    before = runtime.refcount.counts(ref.id)
    _nodes_go(client, address, ref.hex(), prompts_path)
    got = json.loads(client["lines"].wait("NODES client ")[0].split(" ", 2)[2])
    rc = client["proc"].wait(timeout=NODES_TIMEOUT_S)
    wall = time.perf_counter() - client["t0"]
    clients_gone_s = _until(lambda: not runtime._head_server._clients,
                            "the client's connection dropped", 30.0, phase="nodes")
    borrows_s = _until(lambda: runtime.refcount.counts(ref.id) == before,
                       "the client's borrows released", 30.0, phase="nodes")
    want_sha = _sha256(stored["vec"])
    out = {k: got[k] for k in ("connect_s", "wall_s", "launches", "log_seen", "log",
                               "read_s", "device", "bytes", "pid", "leaked_modules")}
    out.update(rc=rc, process_wall_s=wall, token_identical=got["tokens"] == want,
               vector_bit_for_bit_phase19=got["sha256"] == want_sha,
               refcounts_before=list(before),
               refcounts_after=list(runtime.refcount.counts(ref.id)),
               clients_gone_s=clients_gone_s, borrows_released_s=borrows_s)
    log("[nodes] (b) remote driver " + json.dumps({"card": card, **out}))
    _nodes_tokens_ok(got["tokens"], want, got["launches"], "(b) remote driver")
    if rc != 0 or not got["log_seen"] or got["sha256"] != want_sha or got["leaked_modules"]:
        fail(f"[nodes] (b) exit {rc}, log line seen {got['log_seen']}, vector bit for "
             f"bit {got['sha256'] == want_sha}, modules {got['leaked_modules']}")
    if got["log"].get("pid") != got["log"].get("shout_pid"):
        fail(f"[nodes] (b) the pushed line came from {got['log']}")
    return out


def _nodes_death(runtime, daemons, cross: dict, base: str, pids: set, card: str,
                 layers: int, killed: list) -> dict:
    """(c) train again on nodeB (soft affinity); once its result is sealed
    there, SIGKILL nodeB's daemon before anything pulls it. The driver's get
    re-runs train once, on nodeA, by lineage: K6 = K7 counted in that
    re-run, the vector bit for bit (a)'s. nodeB's workers are gone and the
    card's used memory falls."""
    import ray_tpu_torch
    from ray_tpu_torch.models.gpt import gpt2_125m
    from ray_tpu_torch.util.scheduling_strategies import NodeAffinitySchedulingStrategy

    node_b = daemons[1]
    count = os.path.join(base, "recovery.count")
    train = ray_tpu_torch.remote(_store_train).options(
        num_gpus=NODES_GPU, max_retries=1, name="nodes_recovery_train",
        scheduling_strategy=NodeAffinitySchedulingStrategy(
            node_id=node_b["node_id"].hex(), soft=True))
    tokens = _procs_make_tokens(0, TRAIN_B, TRAIN_S + 1)
    ref = train.remote(tokens, gpt2_125m(), TRAIN_STEPS, "cuda", count, False)
    ready, _ = ray_tpu_torch.wait([ref], timeout=NODES_TIMEOUT_S)
    if not ready or runtime.store.location_of(ref.id) != node_b["node_id"]:
        fail("[nodes] (c) train's result is not sealed on nodeB")
    with open(count + ".json") as f:
        first_pid = json.load(f)["pid"]
    b_pids = {first_pid} | {p for p in cross["b_pids"]}
    pids.update(b_pids)
    used_before = _device_used()
    node_b["proc"].kill()
    t0 = time.perf_counter()
    node_b["proc"].wait(timeout=30)
    killed.append(node_b["proc"].pid)
    detect_s = _until(lambda: len(runtime.controller.alive_nodes()) == 2,
                      "nodeB's death seen by the head", 60.0, phase="nodes")
    gone_s = _until(lambda: not any(_pid_alive(p) for p in b_pids),
                    "nodeB's workers gone", 60.0, phase="nodes")
    mib = 2**20
    back_s = _until(lambda: used_before - _device_used() > LEFT_LIMIT_MIB * mib,
                    "nodeB's workers' card memory returning", 60.0, phase="nodes")
    dropped = (used_before - _device_used()) / mib
    t1 = time.perf_counter()
    again = ray_tpu_torch.get(ref, timeout=NODES_TIMEOUT_S)
    recover_s = time.perf_counter() - t1
    runs = len(open(count).read())
    with open(count + ".json") as f:
        rerun = json.load(f)
    pids.add(rerun["pid"])
    same = torch.equal(again, cross["vec"])
    out = {"runs": runs, "rerun_pid": rerun["pid"], "rerun_parent": _ppid(rerun["pid"]),
           "killed_daemon": node_b["proc"].pid, "worker_pids": sorted(b_pids),
           "death_seen_s": detect_s, "workers_gone_s": gone_s, "memory_back_s": back_s,
           "device_used_drop_mib": dropped, "recover_s": recover_s,
           "bit_for_bit": same, "launches": rerun["launches"],
           "since_kill_s": time.perf_counter() - t0}
    log("[nodes] (c) node death " + json.dumps({"card": card, **out}))
    per = layers * TRAIN_STEPS
    _want_counts(rerun["launches"], {"K6 flash_fwd_packed": per, "K7 flash_bwd_packed": per,
                                     "K4 flash_bwd_dq": per, "K5 flash_bwd_dkv": per}, "nodes")
    if runs != 2 or not same or out["rerun_parent"] != daemons[0]["proc"].pid:
        fail(f"[nodes] (c) train ran {runs} times, bit for bit {same}, re-run under "
             f"{out['rerun_parent']} (nodeA's daemon is {daemons[0]['proc'].pid})")
    del again
    return out


def _nodes_restart(heads: list, port: int, gcs: str, want, pids: set, card: str,
                   killed: list) -> dict:
    """(d) Head 1 (a process of its own, GCS persistence on, a fixed port
    and token, listening since the phase's start) and a daemon with a 90 s
    reconnect window: a detached GPT-2 server serves the prompts, the
    snapshot is saved, head 1 is SIGKILLed. The daemon kills and reaps its
    workers: the card's used memory returns to its figure before the actor.
    Head 2 on the same port, token and snapshot: the daemon rejoins,
    get_actor("gpt2") gives a fresh actor on the same daemon that serves
    identical tokens; the KV entry and the job counter survived."""
    limit = LEFT_LIMIT_MIB * 2**20
    daemon = None
    try:
        used0 = _device_used()
        h1, h2 = heads[0]["lines"], heads[1]["lines"]
        listening1 = h1.event("listening")
        daemon = _nodes_daemon(f"127.0.0.1:{port}?token={NODES_TOKEN}", "nodeR",
                               ("--reconnect-window", str(NODES_RECONNECT_S)))
        daemon["lines"].wait("node daemon up")
        served1 = h1.event("served")
        _nodes_tokens_ok(served1["tokens"], want, served1["launches"], "(d) head 1")
        saved = h1.event("saved")
        old = served1["info"]
        pids.add(old["pid"])
        dpid = daemon["proc"].pid
        if old["ppid"] != dpid or saved["detached"] != 1:
            fail(f"[nodes] (d) the actor's parent {old['ppid']} (daemon {dpid}); "
                 f"{saved['detached']} detached actors in the snapshot")
        used_actor = _device_used()
        heads[0]["proc"].kill()
        t_kill = time.perf_counter()
        heads[0]["proc"].wait(timeout=30)
        killed.append(heads[0]["proc"].pid)
        daemon["lines"].wait("daemon: head connection lost", 60.0)
        exit_s = _until(lambda: not _pid_alive(old["pid"]),
                        "the orphaned actor's exit", 60.0, phase="nodes")
        back_s = _until(lambda: _device_used() <= used0 + limit,
                        f"the card's used memory back within {LEFT_LIMIT_MIB} MiB of its "
                        f"figure before the actor", 60.0, phase="nodes")
        used_back = _device_used()
        _nodes_go(heads[1], "second", port, NODES_TOKEN, gcs)
        listening2 = h2.event("listening")
        _, rejoined_at = daemon["lines"].wait("daemon: rejoined head", NODES_TIMEOUT_S)
        joined2 = h2.event("joined")
        served2 = h2.event("served")
        _nodes_tokens_ok(served2["tokens"], want, served2["launches"], "(d) restored actor")
        new = served2["info"]
        pids.add(new["pid"])
        h2.event("down")
        rc2 = heads[1]["proc"].wait(timeout=NODES_TIMEOUT_S)
        daemon_rc = daemon["proc"].wait(timeout=60)
        mib = 2**20
        out = {"port": port, "daemon_pid": dpid, "old_actor_pid": old["pid"],
               "new_actor_pid": new["pid"], "new_actor_parent": new["ppid"],
               "head1_init_s": listening1["init_s"],
               "snapshot": {"bytes": saved["bytes"], "build_s": saved["build_s"],
                            "flush_s": saved["save_s"]},
               "orphan_exit_s": exit_s, "memory_back_s": back_s,
               "device_used_mib": {"before_actor": used0 / mib, "with_actor": used_actor / mib,
                                   "after_kill": used_back / mib},
               "since_kill_to_head2_s": heads[1]["t0"] - t_kill,
               "head2_init_s": listening2["init_s"],
               "rejoin_s": rejoined_at - listening2["at"],
               "head2_init_to_daemon_s": joined2["since_init_s"],
               "head2_init_to_first_token_s": served2["init_to_first_token_s"],
               "kv_survived": listening2["kv"] == NODES_KV[1].hex(),
               "jobs": [listening1["job"], listening2["job"]],
               "token_identical": True, "head1_launches": served1["launches"],
               "launches": served2["launches"], "head2_rc": rc2, "daemon_rc": daemon_rc}
        log("[nodes] (d) head restart " + json.dumps({"card": card, **out}))
        if (new["ppid"] != dpid or new["pid"] == old["pid"] or not out["kv_survived"]
                or not listening2["job"] > listening1["job"] or rc2 != 0):
            fail(f"[nodes] (d) restored actor under {new['ppid']} (daemon {dpid}), pid "
                 f"{new['pid']} (was {old['pid']}), KV survived {out['kv_survived']}, jobs "
                 f"{out['jobs']}, head 2 exit {rc2}")
        return out
    finally:
        if daemon is not None and daemon["proc"].poll() is None:
            daemon["proc"].kill()
            daemon["proc"].wait(timeout=30)


def _nodes_first_head(client: dict, *, card: str, prompts, want, procs: dict,
                      stored: dict, base: str, pids: set, killed: list, daemons: list,
                      layers: int) -> dict:
    """(a)-(c) under a head in this process (isolation="process", no GPU of
    its own, serve_clients(port=0)) and the daemons nodeA and nodeB."""
    import ray_tpu_torch

    summary = {}
    runtime = ray_tpu_torch.init(num_cpus=2, num_gpus=0,
                                 _system_config={"isolation": "process"})
    try:
        address = runtime.serve_clients(port=0)
        summary["daemons"] = _nodes_start(runtime, address, daemons, card)
        # A task that imports torch on each node, beside the server actor's
        # start: it leaves a worker in each node's pool, so the crossings
        # below time the pulls and not a worker's start.
        t0 = time.perf_counter()
        warm = [ray_tpu_torch.remote(_nodes_warm).options(resources={tag: 0.1}).remote()
                for tag in ("nodeA", "nodeB")]
        actor, summary["serve"] = _nodes_serve(prompts, want, daemons, pids, card)
        summary["pooled_workers"] = dict(zip(("nodeA", "nodeB"), ray_tpu_torch.get(
            warm, timeout=NODES_TIMEOUT_S)))
        summary["pooled_workers"]["since_submit_s"] = time.perf_counter() - t0
        pids.update(w["pid"] for w in summary["pooled_workers"].values()
                    if isinstance(w, dict))
        log("[nodes] (a) pooled workers " + json.dumps(
            {"card": card, **summary["pooled_workers"]}))
        host = _nodes_cross(runtime, daemons, procs, stored, base, pids, card, layers,
                            on_card=False)
        on_card = _nodes_cross(runtime, daemons, procs, stored, base, pids, card, layers,
                               on_card=True)
        del on_card["ref"]
        summary["cross_host"], summary["cross_card"] = host, on_card
        summary["client"] = _nodes_remote_driver(runtime, client, address,
                                                 prompts, want, host["ref"], stored,
                                                 base, card)
        host["vec"] = ray_tpu_torch.get(host.pop("ref"), timeout=NODES_TIMEOUT_S)
        host["b_pids"] = [host["pids"][0], on_card["pids"][0]]
        summary["death"] = _nodes_death(runtime, daemons, host, base, pids, card,
                                        layers, killed)
        del host["vec"]
        ray_tpu_torch.kill(actor)
        del actor
    finally:
        ray_tpu_torch.shutdown()
        for d in daemons:
            try:
                d["proc"].wait(timeout=60)
            except subprocess.TimeoutExpired:
                d["proc"].kill()
                d["proc"].wait(timeout=30)
    return summary


def phase_nodes(device_info: dict, server: dict, procs: dict, stored: dict) -> dict:
    """GCS persistence and remote nodes (phase 20): (a) a head with no GPU
    and two daemons (nodeA, nodeB) with the card as their GPU: a GPT-2 125M
    server actor on nodeA, train on nodeB and evaluate on nodeA across the
    object plane, the driver's pull; (b) a remote driver; (c) nodeB's
    death and lineage recovery on nodeA; (d) a head SIGKILLed and restarted
    from its snapshot; (e) no daemon, worker or segment left, and the
    card's memory back."""
    import glob
    import shutil
    import tempfile

    from ray_tpu_torch.models.gpt import gpt2_125m

    t_phase = time.perf_counter()
    card = device_info["smi"]
    want = server["bf16_cold_tokens"]
    prompts = _prompts(np.random.RandomState(0))
    layers = gpt2_125m().num_layers
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    used0, mem0 = _device_used(), torch.cuda.memory_allocated()
    pids: set = set()
    killed: list = []  # SIGKILLed processes: their segments stay behind
    daemons: list = []
    summary = {}
    base = tempfile.mkdtemp(prefix="nodes-phase-")
    # (b)'s remote driver and (d)'s heads start now: each imports torch and
    # the package while (a) runs. Head 1 binds (d)'s port at once and waits
    # for its daemon; head 2 and the driver wait for their arguments.
    port = _nodes_fixed_port()
    gcs = os.path.join(base, "gcs.snap")
    children = {"client": _nodes_child("client", "_nodes_client"),
                "head1": _nodes_child("head first", "_nodes_head"),
                "head2": _nodes_child("head second", "_nodes_head")}
    try:
        _nodes_go(children["head1"], "first", port, NODES_TOKEN, gcs)
        summary.update(_nodes_first_head(children["client"], card=card, prompts=prompts,
                                         want=want, procs=procs, stored=stored, base=base,
                                         pids=pids, killed=killed, daemons=daemons,
                                         layers=layers))
        summary["restart"] = _nodes_restart([children["head1"], children["head2"]], port,
                                            gcs, want, pids, card, killed)
    finally:
        for child in children.values():
            if child["proc"].poll() is None:
                child["proc"].kill()
                child["proc"].wait(timeout=30)
        shutil.rmtree(base, ignore_errors=True)
    exits = {d["tag"]: d["proc"].returncode for d in daemons}
    # (e) A SIGKILLed process cannot remove its own shm segment: each
    # killed daemon's and head's is named by its pid, listed and removed
    # here; no other may be left.
    removed = []
    for pid in killed:
        for path in glob.glob(f"/dev/shm/ray_tpu_torch_{pid}") + glob.glob(
                f"/dev/shm/ray_tpu_torch_node_{pid}"):
            os.remove(path)
            removed.append(os.path.basename(path))
    alive = sorted(p for p in pids | {d["proc"].pid for d in daemons}
                   | {c["proc"].pid for c in children.values()} if _pid_alive(p))
    left = {"segments": sorted(glob.glob("/dev/shm/ray_tpu_torch_*")),
            "killed_processes_segments_removed": removed, "alive": alive,
            "worker_pids": len(pids), "daemon_exit_codes": exits}
    if left["segments"] or alive:
        fail(f"[nodes] after shutdown(): {left}")
    left["left_allocated_mib"] = _settle(mem0, "nodes")
    limit = LEFT_LIMIT_MIB * 2**20
    left["settle_s"] = _until(lambda: _device_used() <= used0 + limit,
                              f"the card's used memory back within {LEFT_LIMIT_MIB} MiB of "
                              f"{used0 / 2**20:.0f} MiB", 30.0, phase="nodes")
    left.update(device_used_start_mib=used0 / 2**20, device_used_end_mib=_device_used() / 2**20)
    summary["teardown"] = left
    log("[nodes] (e) teardown " + json.dumps({"card": card, **left}))
    summary["wall_s"] = time.perf_counter() - t_phase
    log(f"[nodes] phase wall {summary['wall_s']:.1f}s")
    summary["paths"] = {
        "nodes serve": summary["serve"]["launches"],
        "nodes train": _sum_counts([summary[v]["train_launches"]
                                    for v in ("cross_host", "cross_card")]),
        "nodes recovery": summary["death"]["launches"],
        "nodes client serve": summary["client"]["launches"],
        "nodes restored serve": summary["restart"]["launches"],
    }
    return summary


# The cluster phase (21): the dashboard, the autoscaler over node daemons,
# a submitted job and the CLI, around a GPT-2 125M server on an autoscaled
# GPU node.
CLUSTER_GPU = 0.5
CLUSTER_ENGINE = "llm_engine:cluster_gpt2"
CLUSTER_NODE_TYPE = {"resources": {"CPU": 4, "GPU": 1}, "min_workers": 0, "max_workers": 1,
                     "object_store_memory": NODES_STORE_BYTES}
CLUSTER_IDLE_S = 3.0
CLUSTER_UPDATE_S = 1.0
CLUSTER_TIMEOUT_S = 300.0
CLUSTER_ROUTES = ("/", "/api/cluster", "/api/nodes", "/api/tasks", "/api/actors",
                  "/api/objects", "/api/placement_groups", "/api/task_summary", "/api/logs",
                  "/api/timeline", "/api/traces", "/api/metrics_history", "/api/llm",
                  "/api/fleet", "/api/serve", "/api/train", "/metrics")


class _ClusterServer(_GPTServerActor):
    """Phase 20's server actor as a named LLM engine actor
    (`llm_engine:<name>`), which the dashboard's /api/llm and /api/fleet
    panels read; `shout` prints a line on its worker's stdout."""

    def metrics(self) -> dict:
        return self.server.metrics()

    def observability_snapshot(self, steps_limit=None) -> dict:
        return self.server.observability_snapshot(steps_limit)

    def shout(self, marker: str) -> int:
        print(marker, flush=True)
        return os.getpid()


def _cluster_provider(runtime):
    """A SubprocessNodeProvider whose daemons' output is read (the `node
    daemon up` line marks the head's welcome) and whose launches and
    terminations are stamped on this host's clock."""
    from ray_tpu_torch.autoscaler import SubprocessNodeProvider
    from ray_tpu_torch.autoscaler.node_provider import daemon_argv

    class Provider(SubprocessNodeProvider):
        def __init__(self, rt):
            super().__init__(rt)
            self.launched, self.terminated = [], []

        def _launch(self, address, resources, labels, type_config):
            cmd = [sys.executable, "-m", "ray_tpu_torch._private.node_daemon",
                   *daemon_argv(address, resources, labels, type_config)]
            t0 = time.perf_counter()
            proc = subprocess.Popen(cmd, cwd=_ROOT, env=_nodes_env(), text=True,
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            self.launched.append({"t0": t0, "proc": proc, "cmd": cmd[3:],
                                  "lines": _Lines(proc, "node", "cluster")})
            return {"proc": proc}

        def terminate_node(self, node_id):
            self.terminated.append(time.perf_counter())
            super().terminate_node(node_id)

    return Provider(runtime)


def _cluster_train(tokens, cfg, steps: int, device: str) -> dict:
    """Phase 20's train step, in a task of the job: its losses and this
    worker's launches, without the parameters."""
    out = _procs_train(tokens, cfg, steps, device, os.devnull)
    del out["params"]
    out["ppid"] = os.getppid()
    return out


def _cluster_job(argv) -> int:
    """(c)'s job entrypoint, which the job's supervisor runs as `python -c
    'import chip_smoke; ...' ADDRESS` from the repository root: a remote
    driver of the head that submitted it (init(address=...)), which runs
    phase 20's train at CLUSTER_GPU (so on the autoscaled node: the head
    has no GPU) and prints `CLUSTER job {json}`."""
    import ray_tpu_torch
    from ray_tpu_torch.models.gpt import gpt2_125m

    t0 = time.perf_counter()
    ray_tpu_torch.init(address=argv[0])
    connect_s = time.perf_counter() - t0
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "ray_tpu"))
    train = ray_tpu_torch.remote(_cluster_train).options(num_gpus=CLUSTER_GPU,
                                                        name="cluster_job_train")
    tokens = _procs_make_tokens(0, TRAIN_B, TRAIN_S + 1)
    t1 = time.perf_counter()
    out = ray_tpu_torch.get(train.remote(tokens, gpt2_125m(), TRAIN_STEPS, "cuda"),
                            timeout=CLUSTER_TIMEOUT_S)
    out.update(connect_s=connect_s, train_call_s=time.perf_counter() - t1,
               job_pid=os.getpid(), job_id=os.environ.get("RAY_TPU_TORCH_JOB_ID"),
               leaked_modules=leaked)
    ray_tpu_torch.shutdown()
    print("CLUSTER job " + json.dumps(out), flush=True)
    return 0


def _cluster_scale_up(runtime, provider, monitor, prompts, want, want_launches,
                      pids: set, card: str) -> tuple:
    """(a) The server actor at CLUSTER_GPU, infeasible on the GPU-less
    head: the monitor launches one daemon, the actor comes up under it. A
    task that imports torch leaves a worker in the node's pool. The first
    token, then the 8 prompts with the actor's counters set to 0 just
    before and read just after."""
    import ray_tpu_torch
    from ray_tpu_torch.models.gpt import gpt2_125m

    t0 = time.perf_counter()
    actor = ray_tpu_torch.remote(_ClusterServer).options(
        name=CLUSTER_ENGINE, num_gpus=CLUSTER_GPU).remote(gpt2_125m(), _engine_config(), "cuda")
    warm = ray_tpu_torch.remote(_nodes_warm).options(num_gpus=0.01).remote()
    _until(lambda: provider.launched, "a node launched", 60.0, phase="cluster")
    launch = provider.launched[0]
    _, welcome_at = launch["lines"].wait("node daemon up", CLUSTER_TIMEOUT_S)
    info = ray_tpu_torch.get(actor.info.remote(), timeout=CLUSTER_TIMEOUT_S)
    up_at = time.perf_counter()
    base = ray_tpu_torch.get(actor.metrics.remote(), timeout=CLUSTER_TIMEOUT_S)["decode_tokens"]
    first = ray_tpu_torch.get(actor.generate.remote(0, prompts[0], 1), timeout=CLUSTER_TIMEOUT_S)
    first_at = time.perf_counter()
    pooled = ray_tpu_torch.get(warm, timeout=CLUSTER_TIMEOUT_S)
    marker = f"cluster server marker {info['pid']}"
    ray_tpu_torch.get(actor.shout.remote(marker), timeout=CLUSTER_TIMEOUT_S)
    tokens, launches, wall = _serve_prompts(actor, prompts, NODES_N_NEW)
    node = next(n for n in runtime.controller.alive_nodes() if n.total.get("GPU"))
    pids.update((info["pid"], pooled["pid"]))
    out = {"demand_to_launch_s": launch["t0"] - t0, "launch_to_welcome_s": welcome_at - launch["t0"],
           "welcome_to_first_token_s": first_at - welcome_at, "actor_up_s": up_at - t0,
           "daemon": {"pid": launch["proc"].pid, "argv": launch["cmd"]},
           "node": {"id": node.node_id.hex(), "total": dict(node.total)},
           "actor": info, "pooled_worker": pooled, "launches_by_monitor": monitor.autoscaler.num_launches,
           "first_token": first[1], "wall_s": wall,
           "tokens_per_s": NODES_N_NEW * len(prompts) / wall, "token_identical": tokens == want,
           "launches": launches, "phase20_launches": want_launches,
           "generated": [1 + NODES_N_NEW * len(prompts), 1 + len(prompts)],
           "decode_tokens_before": base, "marker": marker}
    log("[cluster] (a) scale-up " + json.dumps({"card": card, **out}))
    _nodes_tokens_ok(tokens, want, launches, "(a) server on the autoscaled node", "cluster")
    if launches != want_launches:
        fail(f"[cluster] (a) launches {launches}, not phase 20's {want_launches}")
    if (info["ppid"] != launch["proc"].pid or pooled["pid"] == info["pid"]
            or len(provider.launched) != 1 or monitor.autoscaler.num_launches != 1
            or node.total != {"CPU": 4.0, "GPU": 1.0}):
        fail(f"[cluster] (a) the actor under {info['ppid']} (daemon {launch['proc'].pid}), "
             f"{len(provider.launched)} launched, node {dict(node.total)}")
    return actor, out


def _cluster_dashboard(runtime, url: str, up: dict, card: str) -> dict:
    """(b) Every route of the head's dashboard: 200 with JSON (the page:
    HTML), its latency; what the routes say of the cluster (a) made."""
    import urllib.request

    from ray_tpu_torch.util.runtime_metrics import _gauges

    history = runtime._metrics_sampler.history
    samples_s = _until(lambda: len(history.snapshot()) >= 2, "two history samples",
                       15.0, phase="cluster")
    got, ms = {}, {}
    for route in CLUSTER_ROUTES:
        t0 = time.perf_counter()
        with urllib.request.urlopen(url + route, timeout=60) as resp:
            status, body = resp.status, resp.read()
            ctype = resp.headers.get("Content-Type", "")
        ms[route] = (time.perf_counter() - t0) * 1e3
        want_type = {"/": "text/html", "/metrics": "text/plain"}.get(route, "application/json")
        if status != 200 or ctype != want_type:
            fail(f"[cluster] (b) {route}: {status} {ctype}")
        got[route] = body.decode() if route in ("/", "/metrics") else json.loads(body)
    node = up["node"]["id"]
    alive = [n for n in got["/api/nodes"] if n["state"] == "ALIVE"]
    gpu = [n["node_id"] for n in alive if n["resources_total"].get("GPU") == 1.0]
    server = [a for a in got["/api/actors"] if a["name"] == CLUSTER_ENGINE]
    llm = [r for r in got["/api/llm"] if r["name"] == CLUSTER_ENGINE]
    decode = llm[0]["metrics"]["decode_tokens"] if llm and "metrics" in llm[0] else None
    tokens, requests = up["generated"]
    gauges = sorted(g.name for g in _gauges().values())
    checks = {
        "two_alive_nodes_one_gpu": len(alive) == 2 and gpu == [node],
        "server_on_the_node": len(server) == 1 and server[0]["node_id"] == node
        and server[0]["state"] == "ALIVE",
        "llm_decode_tokens": decode is not None
        and decode - up["decode_tokens_before"] == tokens - requests,
        "marker_in_logs": any(up["marker"] in r["line"] and r["node_id"] == node
                              for r in got["/api/logs"]),
        "history_samples": len(got["/api/metrics_history"]) >= 2,
        "gauges_in_metrics": all(f"# TYPE {g} gauge" in got["/metrics"] for g in gauges),
        "fleet_has_the_engine": CLUSTER_ENGINE in got["/api/fleet"].get("replicas", {}),
        "page": "ray-tpu-torch dashboard" in got["/"],
        "cluster_alive_nodes": got["/api/cluster"]["alive_nodes"] == 2,
    }
    out = {"url": url, "route_ms": ms, "checks": checks, "history_wait_s": samples_s,
           "history_samples": len(got["/api/metrics_history"]),
           "llm_decode_tokens": decode, "llm_steps": llm[0]["metrics"]["steps"] if llm else None,
           "gauges": len(gauges), "tasks": len(got["/api/tasks"]),
           "timeline_events": len(got["/api/timeline"])}
    log("[cluster] (b) dashboard " + json.dumps({"card": card, **out}))
    if not all(checks.values()):
        fail(f"[cluster] (b) dashboard checks {checks}; nodes {got['/api/nodes']}, "
             f"llm {[{k: v for k, v in r.items() if k != 'flight_record'} for r in llm]}")
    return out


def _cluster_job_run(runtime, address: str, url: str, want_train: dict, up: dict,
                     pids: set, card: str) -> dict:
    """(c) The job (`_cluster_job`) submitted through JobSubmissionClient;
    meanwhile `job status`, `logs --address` and `top --url` run as
    processes against this head."""
    import shlex

    from ray_tpu_torch.job_submission import JobSubmissionClient

    client = JobSubmissionClient()
    code = "import sys, chip_smoke; sys.exit(chip_smoke._cluster_job(sys.argv[1:]))"
    t0 = time.perf_counter()
    job_id = client.submit_job(
        entrypoint=shlex.join([sys.executable, "-c", code, address]),
        runtime_env={"working_dir": _ROOT,
                     "env_vars": {"PYTHONPATH": _nodes_env()["PYTHONPATH"]}},
        metadata={"phase": "cluster"})
    cli = [sys.executable, "-m", "ray_tpu_torch.scripts.cli"]
    commands = {"job status": [*cli, "job", "status", job_id, "--address", address],
                "logs": [*cli, "logs", "--address", address],
                "top": [*cli, "top", "--url", url]}
    cli_out = {}

    def run_cli(name: str, cmd: list) -> None:
        t1 = time.perf_counter()
        proc = subprocess.Popen(cmd, cwd=_ROOT, env=_nodes_env(), text=True,
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        text, _ = proc.communicate(timeout=CLUSTER_TIMEOUT_S)
        cli_out[name] = {"rc": proc.returncode, "wall_s": time.perf_counter() - t1,
                         "pid": proc.pid, "lines": len(text.splitlines()),
                         "tail": text.splitlines()[-2:], "text": text}

    running = [threading.Thread(target=run_cli, args=item) for item in commands.items()]
    for thread in running:
        thread.start()
    status = client.wait_until_finish(job_id, timeout=CLUSTER_TIMEOUT_S, poll_s=0.05)
    job_s = time.perf_counter() - t0
    logs = client.get_job_logs(job_id)
    for thread in running:
        thread.join(CLUSTER_TIMEOUT_S)
    if sorted(cli_out) != sorted(commands):
        fail(f"[cluster] (c) the CLI processes {sorted(commands)} did not all end: {cli_out}")
    pids.update(c["pid"] for c in cli_out.values())
    line = next((ln for ln in logs.splitlines() if ln.startswith("CLUSTER job ")), None)
    if status != "SUCCEEDED" or line is None:
        fail(f"[cluster] (c) job {job_id} {status}: {logs[-3000:]}")
    job = json.loads(line.split(" ", 2)[2])
    pids.update((job["pid"], job["job_pid"]))
    checks = {
        "losses_bit_for_bit_phase20": job["losses"] == want_train["train_losses"],
        "launches_phase20": job["launches"] == want_train["train_launches"],
        "on_the_autoscaled_node": job["ppid"] == up["daemon"]["pid"],
        "job_id_in_env": job["job_id"] == job_id,
        "no_jax_or_ray_tpu": job["leaked_modules"] == [],
        "cli_exit_0": all(c["rc"] == 0 for c in cli_out.values()),
        "cli_job_status": job_id in cli_out["job status"]["text"],
        "cli_logs": up["marker"] in cli_out["logs"]["text"],
        "cli_top": CLUSTER_ENGINE in cli_out["top"]["text"],
    }
    for c in cli_out.values():
        del c["text"]
    out = {"job_id": job_id, "status": status, "submit_to_succeeded_s": job_s,
           "connect_s": job["connect_s"], "train_call_s": job["train_call_s"],
           "train_wall_s": job["wall_s"], "losses": job["losses"], "launches": job["launches"],
           "train_pid": job["pid"], "job_pid": job["job_pid"], "cli": cli_out,
           "checks": checks}
    log("[cluster] (c) job " + json.dumps({"card": card, **out}))
    if not all(checks.values()):
        fail(f"[cluster] (c) job checks {checks}: losses {job['losses']} against "
             f"{want_train['train_losses']}, launches {job['launches']} against "
             f"{want_train['train_launches']}, cli {cli_out}")
    return out


def _cluster_scale_down(runtime, url: str, provider, actor, up: dict, pids: set,
                        used0: int, card: str) -> dict:
    """(d) The server killed: the idle daemon terminated by the monitor
    within CLUSTER_IDLE_S plus two update intervals; it exits 0 having
    reaped its workers; /api/nodes lists the node DEAD; the card's used
    memory back within LEFT_LIMIT_MIB of the phase's start."""
    import urllib.request

    import ray_tpu_torch

    daemon = provider.launched[0]["proc"]
    node = up["node"]["id"]
    mib = 2**20
    used_before = _device_used()
    t0 = time.perf_counter()
    ray_tpu_torch.kill(actor)
    _until(lambda: provider.terminated, "the idle node's termination",
           CLUSTER_IDLE_S + 60.0, phase="cluster")
    terminate_s = provider.terminated[0] - t0
    rc = daemon.wait(timeout=60)
    exit_s = time.perf_counter() - t0
    gone_s = _until(lambda: not any(_pid_alive(p) for p in pids), "the node's workers gone",
                    60.0, phase="cluster")

    def listed_dead() -> bool:
        with urllib.request.urlopen(url + "/api/nodes", timeout=30) as resp:
            return any(n["node_id"] == node and n["state"] == "DEAD"
                       for n in json.loads(resp.read()))

    dead_s = _until(listed_dead, "the node listed DEAD", 30.0, phase="cluster")
    limit = LEFT_LIMIT_MIB * mib
    back_s = _until(lambda: _device_used() <= used0 + limit,
                    f"the card's used memory back within {LEFT_LIMIT_MIB} MiB of "
                    f"{used0 / mib:.0f} MiB", 60.0, phase="cluster")
    bound = CLUSTER_IDLE_S + 2 * CLUSTER_UPDATE_S
    out = {"kill_to_terminate_s": terminate_s, "bound_s": bound, "kill_to_daemon_exit_s": exit_s,
           "daemon_rc": rc, "workers_gone_s": gone_s, "listed_dead_s": dead_s,
           "memory_back_s": back_s, "device_used_mib": {
               "phase_start": used0 / mib, "before_kill": used_before / mib,
               "after": _device_used() / mib},
           "segment_left": os.path.exists(f"/dev/shm/ray_tpu_torch_node_{daemon.pid}"),
           "provider_nodes": provider.non_terminated_nodes()}
    log("[cluster] (d) scale-down " + json.dumps({"card": card, **out}))
    if terminate_s > bound or rc != 0 or out["segment_left"] or out["provider_nodes"]:
        fail(f"[cluster] (d) terminated {terminate_s:.2f}s after the kill (bound {bound}s), "
             f"daemon exit {rc}, segment left {out['segment_left']}")
    return out


def phase_cluster(device_info: dict, server: dict, nodes: dict) -> dict:
    """The dashboard and cluster tooling (phase 21): (a) scale-up, (b) the
    dashboard, (c) a job and the CLI, (d) scale-down, (e) nothing left."""
    import glob

    import ray_tpu_torch
    from ray_tpu_torch.autoscaler import Monitor

    t_phase = time.perf_counter()
    card = device_info["smi"]
    want = server["bf16_cold_tokens"]
    prompts = _prompts(np.random.RandomState(0))
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    used0, mem0 = _device_used(), torch.cuda.memory_allocated()
    pids: set = set()
    summary = {}
    runtime = ray_tpu_torch.init(num_cpus=2, num_gpus=0, _system_config={
        "isolation": "process", "include_dashboard": True, "dashboard_port": 0})
    provider = _cluster_provider(runtime)
    monitor = None
    try:
        address = runtime.serve_clients(port=0)
        config = {"max_workers": 1, "idle_timeout_s": CLUSTER_IDLE_S,
                  "available_node_types": {"gpu": CLUSTER_NODE_TYPE}}
        monitor = Monitor(runtime, config, provider=provider,
                          update_interval_s=CLUSTER_UPDATE_S).start()
        actor, summary["scale_up"] = _cluster_scale_up(
            runtime, provider, monitor, prompts, want, nodes["serve"]["launches"], pids, card)
        summary["dashboard"] = _cluster_dashboard(runtime, runtime.dashboard.url,
                                                  summary["scale_up"], card)
        summary["job"] = _cluster_job_run(runtime, address, runtime.dashboard.url,
                                          nodes["cross_host"], summary["scale_up"], pids, card)
        summary["scale_down"] = _cluster_scale_down(runtime, runtime.dashboard.url, provider,
                                                    actor, summary["scale_up"], pids, used0,
                                                    card)
        del actor
    finally:
        if monitor is not None:
            monitor.stop()
        ray_tpu_torch.shutdown()  # a live daemon gets the head's shutdown frame
        for launch in provider.launched:
            try:
                launch["proc"].wait(timeout=60)
            except subprocess.TimeoutExpired:
                launch["proc"].kill()
                launch["proc"].wait(timeout=30)
    # (e) Nothing left: daemons, workers, job and CLI processes, segments.
    alive = sorted(p for p in pids | {x["proc"].pid for x in provider.launched}
                   if _pid_alive(p))
    left = {"segments": sorted(glob.glob("/dev/shm/ray_tpu_torch_*")), "alive": alive,
            "processes": len(pids) + len(provider.launched),
            "daemon_exit_codes": [x["proc"].returncode for x in provider.launched]}
    if left["segments"] or alive:
        fail(f"[cluster] after shutdown(): {left}")
    left["left_allocated_mib"] = _settle(mem0, "cluster")
    limit = LEFT_LIMIT_MIB * 2**20
    left["settle_s"] = _until(lambda: _device_used() <= used0 + limit,
                              f"the card's used memory back within {LEFT_LIMIT_MIB} MiB of "
                              f"{used0 / 2**20:.0f} MiB", 30.0, phase="cluster")
    left.update(device_used_start_mib=used0 / 2**20, device_used_end_mib=_device_used() / 2**20)
    summary["teardown"] = left
    log("[cluster] (e) teardown " + json.dumps({"card": card, **left}))
    summary["wall_s"] = time.perf_counter() - t_phase
    log(f"[cluster] phase wall {summary['wall_s']:.1f}s")
    summary["paths"] = {"cluster serve": summary["scale_up"]["launches"],
                        "cluster job train": summary["job"]["launches"]}
    return summary


def _all_counters() -> dict:
    """Every kernel's launch counter, K1-K10."""
    from ray_tpu_torch.ops import attn_profile as ap

    return {**_attention_counters(), "K8 attn_dissect": ap.attn_dissect,
            "K9 flash_fwd_slim": ap.flash_fwd_slim, "K10 attn_subtile": ap.attn_subtile}


def _port_py_files() -> int:
    """The .py files of ray_tpu_torch/ outside __pycache__ and _build (the
    analyzer's scan set), counted now: after the build phase filled
    ops/_build/."""
    pkg = Path(_ROOT) / "ray_tpu_torch"
    return sum(1 for p in pkg.rglob("*.py")
               if not {"__pycache__", "_build"} & set(p.relative_to(pkg).parts))


def phase_lint(device_info: dict) -> dict:
    """The port's static analyzer (phase 22): `python3 -m
    ray_tpu_torch.tools.lint ray_tpu_torch --json` from the repo root
    exits 0 with nothing active, unparsed, stale or untriaged, scans
    every .py file of the package outside __pycache__ and _build, and
    reports duration_s < 10; `ray_tpu_torch.scripts.cli lint
    --list-rules` exits 0 naming every rule not ported. No kernel runs."""
    from ray_tpu_torch.tools.lint import NOT_PORTED

    t_phase = time.perf_counter()
    counters = _all_counters()
    for f in counters.values():
        f.launches = 0
    t0 = time.perf_counter()
    scan = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.tools.lint", "ray_tpu_torch", "--json"],
        cwd=_ROOT, capture_output=True, text=True, timeout=120)
    scan_wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    listing = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.scripts.cli", "lint", "--list-rules"],
        cwd=_ROOT, capture_output=True, text=True, timeout=60)
    list_wall = time.perf_counter() - t0
    launches = {k: f.launches for k, f in counters.items()}
    if scan.returncode != 0:
        fail(f"[lint] the scan exited {scan.returncode}: "
             f"{scan.stdout[-2000:]} {scan.stderr[-2000:]}")
    report = json.loads(scan.stdout)
    counts = report["counts"]
    files = _port_py_files()
    summary = {
        "card": device_info["smi"], "files_scanned": report["files_scanned"],
        "py_files": files, "counts": counts, "duration_s": report["duration_s"],
        "scan_wall_s": scan_wall, "list_rules_wall_s": list_wall, "launches": launches,
    }
    bad = {k: counts[k] for k in ("active", "parse_errors", "stale_baseline",
                                  "untriaged_baseline") if counts[k]}
    if bad or report["findings"] or report["parse_errors"]:
        fail(f"[lint] not clean: {bad} {report['findings'][:5]}")
    if report["files_scanned"] != files:
        fail(f"[lint] scanned {report['files_scanned']} files, the package has {files}")
    if not report["duration_s"] < 10:
        fail(f"[lint] the scan took {report['duration_s']} s, over 10 s")
    dropped = listing.stdout.partition("not ported")[2]
    missing = [rid for rid, (_, reason) in NOT_PORTED.items()
               if rid not in dropped or reason not in dropped]
    if listing.returncode != 0 or missing:
        fail(f"[lint] --list-rules exited {listing.returncode}, dropped rules "
             f"missing: {missing}; {listing.stderr[-1000:]}")
    if any(launches.values()):
        fail(f"[lint] kernels launched: {launches}")
    summary["wall_s"] = time.perf_counter() - t_phase
    log("[lint] " + json.dumps(summary))
    return summary


def _replace_attn():
    import dataclasses

    return dataclasses.replace(_engine_config(), attn_impl="reference")


KERNELS = {
    "K1 paged_attention": dict(
        route="cuda", source="ray_tpu_torch/ops/csrc/paged_attention.cu",
        replaces="ray_tpu/ops/paged_flash.py:108",
        main=dict(case="decode", dtype="bf16"),
    ),
    "K2 flash_fwd": dict(
        route="cuda", source="ray_tpu_torch/ops/csrc/flash_fwd.cu",
        replaces="ray_tpu/ops/flash_attention.py:66",
        main=dict(case="prefill", S=256, dtype="bf16"),
    ),
    "K3 flash_bwd_fused": dict(
        route="cuda", source="ray_tpu_torch/ops/csrc/flash_bwd_fused.cu",
        replaces="ray_tpu/ops/flash_attention.py:288",
        main=dict(case="train", dtype="bf16"),
    ),
    "K4 flash_bwd_dq": dict(
        route="cuda", source="ray_tpu_torch/ops/csrc/flash_bwd.cu",
        replaces="ray_tpu/ops/flash_attention.py:194",
        main=dict(case="long", dtype="bf16"),
    ),
    "K5 flash_bwd_dkv": dict(
        route="cuda", source="ray_tpu_torch/ops/csrc/flash_bwd.cu",
        replaces="ray_tpu/ops/flash_attention.py:238",
        main=dict(case="long", dtype="bf16"),
    ),
    "K6 flash_fwd_packed": dict(
        route="cuda", source="ray_tpu_torch/ops/csrc/flash_fwd.cu",
        replaces="ray_tpu/ops/flash_attention.py:443",
        main=dict(case="train", dtype="bf16"),
    ),
    "K7 flash_bwd_packed": dict(
        route="cuda", source="ray_tpu_torch/ops/csrc/flash_bwd.cu",
        replaces="ray_tpu/ops/flash_attention.py:473",
        main=dict(case="train", dtype="bf16"),
    ),
    "K8 attn_dissect": dict(
        route="cuda", source="ray_tpu_torch/ops/csrc/attn_dissect.cu",
        replaces="benchmarks/profile_attn_dissect.py:17",
        main=dict(case="L4", dtype="bf16"),
    ),
    "K9 flash_fwd_slim": dict(
        route="cuda", source="ray_tpu_torch/ops/csrc/attn_slim.cu",
        replaces="benchmarks/profile_attn_variants.py:27",
        main=dict(case="64x64", dtype="bf16"),
    ),
    "K10 attn_subtile": dict(
        route="cuda", source="ray_tpu_torch/ops/csrc/attn_subtile.cu",
        replaces="benchmarks/profile_attn_subtile.py:21",
        main=dict(case="T4", dtype="bf16"),
    ),
}


def kernels_line(rows: list, launches: dict, paths: dict) -> dict:
    """The kernels JSON line. `launches` is each kernel's count on its main
    path; `paths` maps every later path (each counted from 0 just before it
    ran) to its counts, which the entries of the kernels it launched (K1
    and K2 serving, K6 and K7 training the MoE GPT, K2 and K3 the Tune
    trials and the GPT fed by a Dataset) carry as `launches_by_path`."""
    out = []
    for name, meta in KERNELS.items():
        row = next(r for r in rows if r["kernel"] == name
                   and all(r.get(k) == v for k, v in meta["main"].items()))
        out.append({
            "name": name, "route": meta["route"], "source": meta["source"],
            "replaces": meta["replaces"], "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in rows if r["kernel"] == name),
            # K8's levels 1-2 carry the -1e30 mask into outputs of ~1e31, so
            # its absolute error is read beside the relative one.
            "max_rel_l2": max(o["rel_l2"] for r in rows if r["kernel"] == name
                              for o in r["outputs"].values()),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "shape": {k: row[k] for k in ("case", "B", "S", "dtype")},
        })
        by_path = {p: c[name] for p, c in paths.items() if name in c}
        if by_path:
            out[-1]["launches_by_path"] = by_path
    return {"kernels": out}


def _timed(walls: dict, fn, *args):
    """fn(*args), its wall seconds kept in `walls` under the phase's name."""
    t0 = time.perf_counter()
    out = fn(*args)
    walls[fn.__name__.removeprefix("phase_")] = time.perf_counter() - t0
    return out


TP_SIZES = (1, 2, 4)
# bf16 logits of the random GPT-2 125M reach ~|4|, where one bf16 rounding
# step is 2^-6: a tp engine sums its row-parallel partials in another order
# than one card does, and the residual stream is rounded in bf16 at every
# block. The rule holds tp's first-step logits to tp=1's within 4 such
# steps, and lets greedy tokens part only where tp=1's top-2 margin is
# under that.
TP_BF16_TOL = 0.0625


def _cards_used_mib() -> list:
    """Every card's used memory (MiB) by nvidia-smi: all processes, and no
    CUDA context made here on a card this process does not use."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=memory.used", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    return [int(x) for x in smi.stdout.split()]


def _tp_worker_pids() -> list:
    """This process's tensor-parallel rank processes (llm.tp_worker)."""
    pids = []
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/cmdline", "rb") as f:
                cmd = f.read().split(b"\0")
            with open(f"/proc/{entry}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
        except (OSError, IndexError, ValueError):
            continue
        if ppid == os.getpid() and b"ray_tpu_torch.llm.tp_worker" in cmd:
            pids.append(int(entry))
    return pids


def _tp_counters():
    from ray_tpu_torch.ops.flash_attention import flash_attention_fwd
    from ray_tpu_torch.ops.paged_flash import paged_flash_attention

    return {"paged_flash_attention": paged_flash_attention,
            "flash_attention_fwd": flash_attention_fwd}


def _tp_reset(server) -> None:
    """K1's and K2's counters to 0 on every rank."""
    for fn in _tp_counters().values():
        fn.launches = 0
    group = server.engine._tp_group
    if group is not None:
        group.reset_counters()


def _tp_launches(server) -> list:
    """Rank by rank: {"paged_flash_attention": n, "flash_attention_fwd": n}."""
    out = [{k: fn.launches for k, fn in _tp_counters().items()}]
    group = server.engine._tp_group
    if group is not None:
        out += [r["launches"] for r in group.report()]
    return out


def _margins(model, prompt, tokens) -> list:
    """tp=1's top-2 logit margin at each generated step: a full forward of
    its model over the prompt and its own greedy tokens."""
    ids = torch.tensor([list(prompt) + list(tokens[:-1])], device=model.wte.weight.device)
    with torch.no_grad():
        logits = model(ids)[0, len(prompt) - 1:].float()
    top2 = torch.topk(logits, 2, dim=-1).values
    return (top2[:, 0] - top2[:, 1]).tolist()


def _tp_run(dtype, tp: int, prompts, n_new: int) -> dict:
    import dataclasses

    from ray_tpu_torch.llm import LLMServer
    from ray_tpu_torch.models.gpt import gpt2_125m

    mem0 = torch.cuda.memory_allocated()
    label = f"{dtype_label(dtype)} tp={tp}"
    t0 = time.perf_counter()
    server = LLMServer(gpt2_125m(dtype=dtype),
                       dataclasses.replace(_engine_config(), tensor_parallel_size=tp),
                       seed=0)
    up_s = time.perf_counter() - t0
    group = server.engine._tp_group
    procs = group.processes if group is not None else []
    _tp_reset(server)
    results, ttft, wall = _concurrent(server, prompts, n_new)
    launches = _tp_launches(server)
    if any(r is None or len(r) != n_new for r in results):
        fail(f"[tp] {label}: not every request finished with {n_new} tokens")
    for rank, counts in enumerate(launches):
        for name, n in counts.items():
            if n <= 0:
                fail(f"[tp] {label}: {name} was not launched on rank {rank}")
    steps = [r["duration_s"] for r in server.flight_record()["steps"]
             if r["phase"] == "decode"]
    seq = []
    for p in prompts:
        server.reset_prefix_cache()
        seq.append(server.generate(p, max_new_tokens=n_new)["token_ids"])
    runner = server.engine.runner
    with server._lock:
        first = [runner.prefill_logits(p) for p in prompts]
        margins = ([_margins(runner.model, p, t) for p, t in zip(prompts, seq)]
                   if tp == 1 else None)
    ranks_alloc = [torch.cuda.memory_allocated()] + (
        [r["allocated"] for r in group.report()] if group is not None else [])
    out = {
        "tp": tp, "dtype": dtype_label(dtype), "up_s": up_s, "wall_s": wall,
        "tokens_per_s": n_new * len(prompts) / wall,
        "ttft_p50_s": statistics.median(ttft),
        "decode_step_p50_ms": 1e3 * statistics.median(steps),
        "decode_steps": len(steps),
        "launches_by_rank": launches,
        "allocated_mib_by_rank": [b / 2**20 for b in ranks_alloc],
        "pool_bytes_per_rank": server.metrics()["kv_pool_bytes_per_shard"],
        "kv_pool_sharding": server.metrics()["kv_pool_sharding"],
    }
    _free(server)
    del server, runner
    _until(lambda: all(p.poll() is not None for p in procs),
           f"{label}: every rank process gone after the server's shutdown", phase="tp")
    out["left_mib"] = _settle(mem0, f"tp {label}")
    # Every card's used memory (nvidia-smi) after this run's teardown.
    out["used_mib_after"] = _cards_used_mib()
    out["reserved_mib_after"] = torch.cuda.memory_reserved() / 2**20
    log("[tp] " + json.dumps(out))
    out.update(tokens=seq, first_logits=first, margins=margins)
    return out


def _tp_bf16_rule(base: dict, run: dict) -> dict:
    """The bf16 rule (TP_BF16_TOL) of one tp run against tp=1's."""
    worst = max(float(np.abs(a - b).max())
                for a, b in zip(run["first_logits"], base["first_logits"]))
    if worst > TP_BF16_TOL:
        fail(f"[tp] bf16 tp={run['tp']}: first-step logits {worst} from tp=1's, "
             f"past {TP_BF16_TOL}")
    parted = []
    for i, (got, want, margin) in enumerate(zip(run["tokens"], base["tokens"],
                                                 base["margins"])):
        at = next((j for j, (a, b) in enumerate(zip(got, want)) if a != b), None)
        if at is None:
            continue
        parted.append({"prompt": i, "step": at, "tp1_margin": margin[at]})
        if margin[at] >= TP_BF16_TOL:
            fail(f"[tp] bf16 tp={run['tp']} prompt {i} parts from tp=1 at step {at}, "
                 f"where tp=1's top-2 margin {margin[at]} is not under {TP_BF16_TOL}")
    rule = {"tp": run["tp"], "first_logits_max_abs_diff": worst, "parted": parted,
            "identical_prompts": len(run["tokens"]) - len(parted)}
    log("[tp] bf16 rule: " + json.dumps(rule))
    return rule


def _tp_serve(prompt, n_new: int) -> dict:
    """One request at tp=2 through serve.run(build_app(...))."""
    import dataclasses

    import ray_tpu_torch
    from ray_tpu_torch import serve
    from ray_tpu_torch.llm.serve import build_app
    from ray_tpu_torch.models.gpt import gpt2_125m

    mem0 = torch.cuda.memory_allocated()
    ray_tpu_torch.init(num_cpus=8)
    t0 = time.perf_counter()
    try:
        handle = serve.run(build_app(
            gpt2_125m(), dataclasses.replace(_engine_config(), tensor_parallel_size=2),
            engine_name="tp2", seed=0), name="tp2")
        got = handle.remote({"prompt_ids": prompt, "max_new_tokens": n_new}).result(
            timeout_s=600)
        wall = time.perf_counter() - t0
        engine = ray_tpu_torch.get_actor("llm_engine:tp2")
        stats = ray_tpu_torch.get(engine.metrics.remote(), timeout=60)
        pids = _tp_worker_pids()
    finally:
        # The app, then its shared engine (its shutdown stops rank 1), then
        # the runtime: the sweep cells' order (ROADMAP §D8).
        serve.shutdown()
        try:
            ray_tpu_torch.get(engine.shutdown.remote(), timeout=60)
            ray_tpu_torch.kill(engine)
        finally:
            ray_tpu_torch.shutdown()
    if len(pids) != 1:
        fail(f"[tp] the tp=2 serve app runs {len(pids)} rank processes, not 1")
    _until(lambda: not any(_pid_alive(p) for p in pids),
           "the serve app's rank process gone after its engine's shutdown", phase="tp")
    out = {"tokens": got["token_ids"], "wall_s": wall,
           "tensor_parallel_size": stats["tensor_parallel_size"],
           "kv_pool_sharding": stats["kv_pool_sharding"]}
    out["left_mib"] = _settle(mem0, "tp serve")
    out["used_mib_after"] = _cards_used_mib()
    out["reserved_mib_after"] = torch.cuda.memory_reserved() / 2**20
    log("[tp] serve: " + json.dumps({k: v for k, v in out.items() if k != "tokens"}))
    return out


def _tp_cards_back(used: list, used0: list, card0: int, label: str) -> None:
    """The memory rule after a teardown (module doc): cards 1.. within
    LEFT_LIMIT_MIB of the phase's start, card 0 within LEFT_LIMIT_MIB of
    its level after the phase's first tp > 1 run."""
    want = [card0] + list(used0[1:])
    for i, (a, b) in enumerate(zip(want, used)):
        if b > a + LEFT_LIMIT_MIB:
            fail(f"[tp] {label}: card {i} holds {b} MiB after the teardown, "
                 f"{a} MiB the bound's base (limit {LEFT_LIMIT_MIB} MiB)")


def _tp_kill_inside_a_step(prompt) -> dict:
    """A rank that dies inside a step on NCCL: rank 1 of a tp=2 engine
    stopped (alive, so the step's header goes out and rank 0 enters the
    step's collectives) and killed a second later. The step must raise
    TensorParallelError naming rank 1 within TP_TIMEOUT_S of the kill (the
    group's fence aborts the communicator, which ends rank 0's waiting
    kernels), rank 0's stream must drain, and the engine's shutdown return."""
    import dataclasses
    import signal
    import threading

    from ray_tpu_torch.llm import LLMEngine
    from ray_tpu_torch.models.gpt import gpt2_125m
    from ray_tpu_torch.parallel import TP_TIMEOUT_S, TensorParallelError

    engine = LLMEngine(gpt2_125m(), dataclasses.replace(
        _engine_config(), tensor_parallel_size=2), seed=0)
    try:
        if len(engine.generate([prompt], max_new_tokens=4)[0]) != 4:
            fail("[tp] kill: the tp=2 engine did not generate before the kill")
        rank1 = engine._tp_group.processes[0]
        os.kill(rank1.pid, signal.SIGSTOP)
        killer = threading.Timer(1.0, os.kill, (rank1.pid, signal.SIGKILL))
        t0 = time.perf_counter()
        killer.start()
        try:
            engine.generate([prompt], max_new_tokens=4)
            fail("[tp] kill: a step whose rank 1 was killed inside it raised nothing")
        except TensorParallelError as exc:
            error = str(exc)
        finally:
            killer.join()
        raised_s = time.perf_counter() - t0 - 1.0
    finally:
        engine.shutdown()
    if "rank 1" not in error or raised_s > TP_TIMEOUT_S:
        fail(f"[tp] kill: raised {raised_s:.3f}s after the kill: {error}")
    event = torch.cuda.Event()
    event.record()
    _until(event.query, "rank 0's stream drained after the abort", phase="tp")
    if torch.ones(4, device="cuda").sum().item() != 4:
        fail("[tp] kill: rank 0's card computes wrong after the abort")
    _until(lambda: rank1.poll() is not None, "the killed rank reaped", phase="tp")
    out = {"raised_s_after_kill": raised_s, "bound_s": TP_TIMEOUT_S, "error": error}
    log("[tp] kill inside a step: " + json.dumps(out))
    return out


def phase_tp() -> dict:
    """The tp phase (module doc): `python3 chip_smoke.py --phase tp`."""
    t0 = time.perf_counter()
    cards = torch.cuda.device_count()
    if cards < 2:
        fail(f"the tp phase needs at least 2 cards; {cards} visible")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    for line in smi.stdout.strip().splitlines():
        log(line)
    torch.zeros(1, device="cuda")  # rank 0's context, before the baseline
    used0 = _cards_used_mib()
    log(f"[tp] cards {cards}, used MiB before: {used0}")
    sizes = [tp for tp in TP_SIZES if tp <= cards]
    prompts = _prompts(np.random.RandomState(0))
    n_new = 32
    runs = {("f32", 1): _tp_run(torch.float32, 1, prompts, n_new)}
    # The serve app is the phase's first tp > 1 run: card 0's level after
    # it is the base of card 0's memory rule (module doc).
    served = _tp_serve(prompts[0], n_new)
    card0 = served["used_mib_after"][0]
    _tp_cards_back(served["used_mib_after"], used0, card0, "serve")
    for dtype in (torch.float32, torch.bfloat16):
        for tp in sizes:
            key = (dtype_label(dtype), tp)
            if key not in runs:
                runs[key] = _tp_run(dtype, tp, prompts, n_new)
                _tp_cards_back(runs[key]["used_mib_after"], used0, card0,
                               f"{key[0]} tp={tp}")
    for tp in sizes[1:]:
        got, want = runs[("f32", tp)]["tokens"], runs[("f32", 1)]["tokens"]
        if got != want:
            bad = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
            fail(f"[tp] f32 tp={tp} tokens differ from tp=1's on prompts {bad}")
    log(f"[tp] f32 tokens at tp={sizes[1:]} equal tp=1's on all {len(prompts)} prompts")
    rules = [_tp_bf16_rule(runs[("bf16", 1)], runs[("bf16", tp)]) for tp in sizes[1:]]
    if served["tokens"] != runs[("bf16", 2)]["tokens"][0]:
        fail("[tp] the tp=2 serve app's tokens differ from the tp=2 server's")
    if served["tensor_parallel_size"] != 2:
        fail(f"[tp] the serve app's engine reports tp={served['tensor_parallel_size']}")
    used1 = _cards_used_mib()
    log(f"[tp] cards' used MiB after every teardown: {used1} (before the phase: "
        f"{used0}; card 0 after the tp=1 run {runs[('f32', 1)]['used_mib_after'][0]}, "
        f"after the first tp > 1 run {card0})")
    _tp_cards_back(used1, used0, card0, "the phase")
    killed = _tp_kill_inside_a_step(prompts[0])
    summary = {
        "cards": cards, "sizes": sizes, "bf16_tol": TP_BF16_TOL,
        "runs": [{k: v for k, v in r.items()
                  if k not in ("tokens", "first_logits", "margins")}
                 for r in runs.values()],
        "bf16_rule": rules,
        "serve": {k: v for k, v in served.items() if k != "tokens"},
        "used_mib_before": used0, "used_mib_after": used1,
        "card0_base_mib": card0, "kill_inside_a_step": killed,
        "wall_s": time.perf_counter() - t0,
    }
    log(f"[tp] phase wall {summary['wall_s']:.1f}s")
    return summary


def main_tp() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = phase_device()
    summary = phase_tp()
    print(json.dumps({"tp": summary}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device["name"],
        "count": torch.cuda.device_count(),
    }}))
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    walls: dict = {}
    device = _timed(walls, phase_device)
    _timed(walls, phase_build)
    rows = _timed(walls, phase_kernels)
    profile = _timed(walls, phase_profile, rows)
    launches = dict(_timed(walls, phase_train)["launches_main"])
    trainer = _timed(walls, phase_trainer)
    launches["K3 flash_bwd_fused"] = trainer["launches"]["K3 flash_bwd_fused"]
    server = _timed(walls, phase_server)
    launches.update(server["launches"])
    _timed(walls, phase_serving_modes)
    _timed(walls, phase_serve, server)
    loadgen = _timed(walls, phase_loadgen)
    fabric = _timed(walls, phase_fabric)
    resnet = _timed(walls, phase_resnet, device)
    moe = _timed(walls, phase_moe, server)
    tuned = _timed(walls, phase_tune)
    rllib = _timed(walls, phase_rllib, device)
    algos = _timed(walls, phase_rllib_algos, device)
    data = _timed(walls, phase_data, device, trainer, resnet)
    procs = _timed(walls, phase_procs, device, server, trainer, data)
    stored = _timed(walls, phase_store, device, server, procs)
    nodes = _timed(walls, phase_nodes, device, server, procs, stored)
    cluster = _timed(walls, phase_cluster, device, server, nodes)
    _timed(walls, phase_lint, device)
    launches.update(profile["launches"])
    paths = {"server": server["launches"]}
    for line in loadgen["cells"]:
        paths[f"loadgen {line['cell']}"] = line["launches"]
    paths["fabric cold restore bf16"] = fabric["spill_bf16"]["launches"]
    paths["fabric cold restore f32"] = fabric["spill_f32"]["launches"]
    for role, counts in fabric["disagg"]["launches_by_role"].items():
        paths[f"fabric disaggregated {role}"] = counts
    paths["moe train"] = moe["train"]["launches"]
    paths["moe server"] = moe["serve"]["launches"]
    paths["tune asha"] = tuned["asha"]["launches"]
    paths["tune pbt"] = tuned["pbt"]["launches"]
    paths["rllib ppo"] = rllib["ppo"]["launches"]
    paths["rllib impala"] = rllib["impala"]["launches"]
    for name in ("dqn", "dqn_prioritized", "apex", "sac", "td3", "appo", "a2c"):
        paths[f"rllib {name}"] = algos[name]["launches"]
    for name in ("bc", "cql"):
        paths[f"rllib {name}"] = algos["offline"][name]["launches"]
    for name in ("shared", "per_policy"):
        paths[f"rllib multi-agent {name}"] = algos["multi_agent"][name]["launches"]
    paths["data gpt2"] = data["gpt2"]["launches"]
    paths["data resnet"] = data["resnet"]["launches"]
    paths.update(procs["paths"])
    paths.update(stored["paths"])
    paths.update(nodes["paths"])
    paths.update(cluster["paths"])
    log("[phases] " + json.dumps(walls))
    log(f"[done] {time.perf_counter() - t_start:.1f}s")
    print(json.dumps(kernels_line(rows, launches, paths)))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device["name"],
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--phase", "tp"]:
        sys.exit(main_tp())
    if sys.argv[1:]:
        sys.exit(f"usage: {sys.argv[0]} [--phase tp]")
    sys.exit(main())
