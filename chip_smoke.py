#!/usr/bin/env python3
"""Run the PyTorch + CUDA port's main path on one NVIDIA GPU and check it.

Usage::

    python3 chip_smoke.py [--seed N]

Phases, each printing one JSON line (any failure exits non-zero):

1. device — the card's name and power limit (``nvidia-smi``);
2. build — compiles the CUDA kernels from ``src/repro_torch/kernels/csrc``;
3. kernels — the water-level kernel (K1/K2) against its plain PyTorch
   version on the card, bit for bit, at widths up to its 32768-lane
   ceiling (lanes at and above BIG included); then the fused
   water-filling kernel (the K-group scan, and the B-job eq. 2 chain, in
   one launch) against its plain loop, bit for bit, on groups of 1 to 4096
   live lanes, ties, demand 0, one available server, busy at the BIG
   boundary, available lanes at exactly BIG and levels raised past it,
   K in {1, 8}, B in {1, 8}, M in {2, 4096, 32768};
4. rd kernel — the RD step kernel (one iteration of device RD's
   deletion or dedup loop per launch) against its plain iteration in
   lockstep, every buffer bit for bit after every iteration (the plain
   iteration and the comparisons replayed as one CUDA graph a loop): on
   the main path's first job and on edge cases (ties, no candidates,
   quota past the total, int32 extremes, a free-slot shortage, rows 33-64
   ids wide, the server and slot ceilings);
5. main path — the online scheduler (``SchedulingEngine`` with
   ``wf_torch``) on a bursty trace at 4096 servers under ``fifo`` (the
   burst chain) and ``ocwf-acc`` (the first 300 of its 1000 jobs), each
   schedule identical to the host ``wf`` on the same jobs; then the
   independent-problems batch entry
   point ``water_filling_torch_batch`` over the trace's bursts; one fused
   launch per ``wf_torch`` adapter call, whatever its K or B, no K1/K2
   launch and no plain call.  Launch counts are zeroed just before each
   path and read just after;
6. rd main path — the same engine with ``rd_torch`` on the same trace's
   first jobs (three same-slot bursts through the device RD chain, then
   the first burst again one arrival at a time), each schedule identical
   to the host ``rd``, with one kernel launch per loop iteration, no
   plain iteration and no host re-run, and the most slots each job held
   live against its slot capacity; then one problem with groups of 40-64
   of the 4096 servers against the host ``rd``;
6a. control plane — ``SchedulingEngine(..., step_mode="event")`` with
   ``wf_torch`` on the whole trace: JCTs, makespan and failed set equal to
   the slot loop's (5.) and the host ``wf`` plane's, one fused launch per
   adapter call, the event loop's wall beside the slot loop's; then
   ``ControlPlane(policy="rd_torch", ordering="setf")`` on the first 18
   jobs against the host ``rd`` plane (K3 launches = loop iterations, no
   host re-run);
6b. faults online — the first 200 jobs replayed at half the saturation
   rate, ``wf_torch`` against host ``wf`` on the plane under one timeline
   each: a 128-server rack failure with retry, a rotating straggler with
   stealing and speculation (and the plain plane, for the mean JCT they
   buy), and the jobs re-timed past saturation with admission control;
   every JCT, failed and shed set and counter identical;
6c. exact — OBTA and NLIP on the first 40 arrival problems of 6a's
   ``wf_torch`` run: Φ_obta = Φ_nlip ≤ Φ(wf_torch) ≤ K_c · Φ_obta, and
   Φ_obta ≤ Φ(rd_plus) ≤ Φ(rd_torch) = Φ(rd); their host times; then
   the plane with ``obta`` on the whole trace, and ``rd_plus``, ``obta``
   and ``wf_torch`` on the first 30 jobs (mean and p99 JCT);
6d. plane serve — two Mamba2-130M replicas at full width behind a
   ``wf_torch`` router serve 8 requests through ``ControlPlane.
   submit_request`` while the plane schedules the first 50 jobs; the
   tokens equal the same pool's driven alone;
6e. observed main path — the fifo run of 5. again under
   ``repro_torch.obs.observe()`` (a ring holding the whole trace): the
   schedule equals the unobserved run's, ``device.wf-*.calls`` equal the
   adapter calls and the fused launches; the trace's size, both walls and
   the first-launch / later-launch split; then ``ControlPlane(rd_torch,
   setf)`` on the first 5 jobs under a session, equal to the host ``rd``
   plane, ``device.rd-device.calls`` equal to the device RD runs; the
   Chrome export round-trips through ``parse_chrome_trace``;
6f. csv replay — a headerless ``batch_task.csv`` in cluster-trace-v2017's
   8-column schema, drawn from the seed at the paper's segment size (250
   jobs, 113,653 task instances, 1-8 groups a job, ~2 % of the rows not
   Terminated), replayed by ``generate("cluster_v2017", path=...)`` in
   4096-row chunks at the trace's 1,300 machines: equal to a replay in
   97-row chunks and to a one-shot ``load_batch_task_csv``; ``wf_torch``
   fifo over all 250 jobs and ``rd_torch`` over the first 10, each
   identical to the host policy;
6g. moe balance — DeepSeek-V3's 256 routed experts (top-8, 4 x 2048
   tokens a step) on its 32-GPU prefill unit, two replicas an expert, 50
   steps carrying the queue: ``balance_expert_replicas`` on the card (one
   fused launch a call) equal to the plain loop, tokens conserved, Φ at
   most the static first-replica split's;
7. model kernels — the RMSNorm, decode-attention and flash-attention
   kernels against their plain versions on the card, in float32 (flash
   attention on the CUDA cores) and bfloat16 (on the tensor cores), at
   the serving path's shapes, at Qwen3-32B's head layout (64 query / 8
   KV heads) and Qwen3-MoE's (64 / 4: decode attention's group of 16 in
   two slices, and a group of 12), at every compiled head width, at ragged lengths (T > S and
   T < S), through the model's strided views; decode attention with pos
   on its split boundaries, pos 0, pos >= T and an 8192-position cache;
7a. attention widths — K5 at a group of 32 (128 query / 4 KV heads, T
    1024, hd 128) and 64, and at hd 256, 96 and 33 (group 4); K6 causal
    and not at hd 256, 96 (the tensor cores in bf16) and 72 (the
    any-width kernel), and at hd 72 through strided views; float32 and
    bf16, each against its plain version within the model tolerance
    (bf16 also against the float32 plain, as 14e), one kernel launch a
    case and no plain call; each case's µs (CUDA events), the bf16 ones
    against plain, SDPA and the bound on rotating input copies (as 14e);
8. serve parity — the port's ``ServeEngine`` on the card (kernels)
   against the port on the CPU (plain versions) on both smoke configs in
   float32: identical tokens, and the logits' largest difference;
9. serve main path — Qwen1.5-4B at full width (40 layers, bf16, random
   seeded weights): two ``ServeEngine`` replicas behind
   ``RoutedServePool`` with ``ReplicaRouter(policy="wf_torch")`` serve
   8 requests; every request finishes with its 32 tokens, through the
   kernels, with no plain call, each request routed by one fused
   water-filling launch;
10. prefill path — ``make_prefill_step`` on 4 prompts of 2048 tokens,
    one decode step from its cache, held against a prefill over the 2049
    tokens; every flash-attention launch on the tensor cores;
11. model timings — device times of K4/K5/K6, their plain versions and
    one PyTorch library call each, with their bounds (K4 at decode and
    prefill rows, K5 over a full cache, at 301 keys and at Qwen3-MoE's
    group of 16);
12. ssm kernels — the SSD scan kernel (K7) against its plain version at
    both SSM models' prefill shapes, ragged lengths (1, 63, 65, 200,
    2000, 2047), a batch of 1, every compiled (P, N) and the model's
    strided conv slices, in float32 (CUDA cores) and bfloat16 (tensor
    cores, chunk-parallel); flash and
    decode attention at Zamba2's head width 80 (strided views, split
    boundaries); then the timings of K7 at both prefill shapes and of K6
    at head width 80;
13. ssm serve parity — as 8., on the mamba2-130m and zamba2-2.7b smoke
    configs, logits within 1e-4;
14. mamba2 / zamba2 serve — Mamba2-130M (one ``ServeEngine``) and
    Zamba2-2.7B (two behind a ``wf_torch``-routed pool) at full width,
    bf16, random seeded weights, 8 requests each, with exact K4 / K5
    launches per decode step and a profiled decode step; then each
    model's 4 x 2048-token prefill (K7 on the tensor cores once per Mamba2
    layer, K6 on the tensor cores once per use of Zamba2's shared block)
    and its
    continuation check: 1792
    tokens prefilled and 256 decoded against the 2048-token prefill,
    within 1e-3 of the largest logit in float32, the bf16 gap reported;
14a. moe serve parity — as 8., on the qwen3-moe-235b-a22b and
    deepseek-v3-671b smoke configs, logits within 1e-4;
14b. moe / mla_moe serve — Qwen3-MoE-235B-A22B at its published widths
    (d 4096, 64 query / 4 KV heads, 128 experts top-8, vocab 151,936), 4
    of its 94 layers, two replicas behind the ``wf_torch`` pool serving
    the dense cell's 8 requests (K4, K5 at a group of 16, the fused WF
    kernel); DeepSeek-V3-671B (d 7168, 128 heads of MLA, 256 routed + 1
    shared experts top-8, vocab 129,280), 2 of its 61 layers and no MTP
    block, one engine serving 6 requests of 32-128 tokens, 16 new (K4
    only: MLA calls no kernel); every request finishes, logits finite,
    exact K4 / K5 launches a step, no plain call, a profiled decode step;
    then each model's prefill at the published capacity factor 1.25 (4 x
    2048 tokens through K6 at group 16; 2 x 2048 for DeepSeek-V3) with the
    share of routed assignments dropped, and the prefill -> decode handoff
    at capacity factor E / k (nothing drops) within 5 % of the largest
    logit, as 10.;
14c. vlm serve — LLaVA-NeXT-Mistral-7B at full width and depth (32
    layers, d 4096, 32 query / 8 KV heads of 128, vocab 32,000, ~7.2 G
    parameters in bf16, seeded): 4 sequences of 576 seeded patch
    embeddings (the stubbed vision tower, as in the reference) + 64
    tokens prefilled, 32 decode steps; the last step's logits against one
    prefill of the extended sequence within 5 % of the largest logit,
    clear argmaxes agreeing; exactly 65 K4 launches a pass, 32 K6 (tensor
    cores) in the prefill, 32 K5 a step, no plain call; ms a step and the
    peak memory;
14d. train — Qwen1.5-4B at full width, 4 of its 40 layers, 4 x 1024
    tokens, and Mamba2-130M whole, 4 x 2048, bf16 with AdamW's moments in
    bf16, on one batch from ``LocalityAwareLoader`` (its shard reads
    placed by ``water_filling_torch`` on the card): step 1's gradients
    through the kernels' autograd Functions against the plain versions'
    (bf16: the global norms within 1e-2, the whole gradient's relative
    L2 distance within 5e-2, every leaf's within 1.5e-1; the model
    upcast to float32: all three within 1e-3),
    then 20 ``make_train_step`` steps (the loss falls by 0.3 at least;
    exactly 2L + 1 K4 and L K6 (Qwen) or L K7 (Mamba2) launches a step,
    no plain call); ms a step, tokens/s, peak memory; the train state
    saved (async) and restored through ``CheckpointManager`` with every
    leaf identical, and placed by ``register_checkpoint``;
14e. encdec kernels — K6 not causal at Whisper-medium's shapes (4
    sequences, 16 query over 16 KV heads of 64): S = T = 1500 (the
    encoder), S = 64 and S = 1 against T = 1500 (cross-attention at
    prefill and decode: a ragged 92-key tail, one query row of a 128-row
    tile), the encoder and S = 1 again on inputs where a key mask off by
    one key moves every output past the limit (the "ramp" cases), the
    decoder's causal prefill through strided views, and K5 at a group of 1
    over 1024 keys; float32 and bf16, each against its plain version, the
    bf16 ones also against the float32 plain within 2**-6 of the largest
    output, one launch a case, no plain call; the bf16 random cases timed
    on rotating input copies (past the L2) against plain, SDPA and the
    bound;
14f. encdec serve — Whisper-medium at full width and depth (24 encoder +
    24 decoder layers, d 1024, vocab 51,865, 0.96 G parameters in bf16,
    seeded; the conv frontend stubbed as the reference stubs it: 1500
    seeded N(0, 1) frame embeddings a sequence): 4 sequences encoded and a
    64-token prompt prefilled, 32 decode steps; the last step's logits
    against one prefill of the extended sequence within 5 % of the largest
    logit, clear argmaxes agreeing; exactly 122 K4 and 72 K6 (tensor
    cores) in the prefill, 73 K4, 24 K5 and 24 K6 (cross-attention) a
    step, no plain call; a profiled decode step; a float32 copy of 2 + 2
    layers at full width through the kernels against the plain versions
    within 1e-4 (prefill and 4 steps);
14g. encdec train — Whisper-medium at full depth, bf16, bf16 AdamW
    moments, 4 x (1500 frames + 448 loader tokens), 20 steps: the loss
    falls by 0.3 at least; step 1's gradients (on 2 of the sequences)
    through the kernels against the plain path as in 14d; exactly 170 K4
    and 96 K6 (tensor cores) a step (the encoder's layers recomputed in
    the backward, as the reference's ``jax.checkpoint``), no plain call;
14h. launch train — ``repro_torch.launch.train.main`` on the card:
    Mamba2-130M whole, 60 steps into a temporary ``--ckpt-dir`` (an async
    save at step 50, the final save at 60), then again with ``--steps
    70``, which resumes from step 60; 97 K4 and 48 K7 a step (the
    driver's ``remat``: the forward, then each layer again), no plain
    call, no WF launch (its loader keeps the host ``water_filling``);
14i-14k. (in a world of one NCCL rank on ``cuda:0``, a ``FileStore``
    rendezvous in a temporary directory, a (1, 1) (data, model) mesh;
    the group destroyed however the slice ends) parallel train — the
    sharded train step (``make_train_step(..., mesh=)``) and the
    single-device step, 3 steps each from one seeded state on Qwen1.5-4B
    (4 of 40 layers, 4 x 1024, bf16, bf16 moments): the losses within
    1e-4 and every parameter within 5e-4 (the reference test's limits),
    a float32 copy's first step too; 9 K4 and 4 K6 launches a step on
    both sides, no plain call; moe sharded — ``moe_apply_sharded`` on
    one Qwen3-MoE-235B-A22B FFN (128 experts, top 8, width 1536) over
    4 x 1024 bf16 tokens at capacity factor 1.25: the kept set identical
    to ``moe_apply``'s, y and aux within MODEL_TOL; compress — int8
    gradients with error feedback on the reference test's regression:
    one step within 2 % of the exact gradient, 300 steps within 0.05 of
    the target;
14l. dryrun check — the dry run's counts (``repro_torch.launch.dryrun``)
    against real steps: Qwen1.5-4B and Mamba2-130M at full width and 2
    layers, a train step, a prefill and a decode step at 2 x 1024 through
    ``launch.specs.step_fn_for`` on a (1, 1) mesh, counted on ``meta``
    in a fake world of one rank and run for real (counted the same way)
    in a world of one NCCL rank: the FLOP counts equal exactly, each
    step's kernels launched as many times as the meta count's calls,
    meta ``peak_bytes`` within 10 % of ``torch.cuda.max_memory_allocated``
    over the step, each step's time beside its bound under the H100's
    data-sheet peaks (printed), ``dryrun.HBM_BYTES`` equal to the card's
    ``total_memory``;
14m. examples — the four ``examples_torch`` scripts (the reference's
    ``examples/*.py`` entry points), each through its ``main`` on the card
    and again with ``--device cpu`` (in the host worker, started after 6c
    and run beside the card's phases), its output captured: quickstart (NLIP,
    OBTA, WF through ``wf_torch``, RD through ``rd_torch``, RD+, then a
    40-job trace FIFO vs OCWF-ACC), fault tolerance (a 60-job trace
    healthy, with two failures, with two stragglers) and the serving
    example (continuous batching on the qwen1.5-4b smoke config, its
    weights drawn once on the CPU; ``wf_torch`` replica routing; MoE
    expert-replica balancing) print the same text on both; the training
    example (Mamba2-130M cut to d_model 256 and 4 layers, float32, from
    one set of seeded weights: 26 steps failing a data host, then resumed
    to 51 with the int8 compression demo) prints losses within 1e-3 and
    every other line equal; on the card the fused WF launches equal the
    ``wf_torch`` adapter calls (plus the serving example's MoE call), K3
    launches in the quickstart, K4 and K5 in serving, K4 and K7 in
    training, no plain call;
14n. partition check — the partitioned dense strategy
    (``parallel/partition.py``): in a world of one NCCL rank on a (1, 1)
    mesh, Qwen1.5-4B at full width, 2 layers, 2 x 1024, bf16: the
    partitioned prefill (through ``step_fn_for``) bit for bit against
    ``prefill``, and 2 partitioned train steps (remat on) against the
    single-device step within 1e-4 / 5e-4, K4 and K6 launched as often on
    both sides (9 and 4 a step), no plain call; then, where torch's
    ``fake`` backend takes CUDA tensors, rank 0 of a fake (16, 16) world
    at Qwen3-32B's full width, 2 layers, train_4k's 256 x 4096: the train
    step's FLOPs and collective calls on the card equal the ``meta`` count, its
    peak within 3 % of ``max_memory_allocated``, K6's counted operations
    those of 4 local query heads (else the refusal on a line of its own);
14o. partition decode — the partitioned dense decode step
    (``Partitioned.decode``: the cache's sequence on ``model``, K5's
    partial mode, the shards' softmaxes combined): on a (1, 1) mesh in a
    world of one NCCL rank, Qwen1.5-4B at full width, 2 layers, 2 x 1024
    prompts, the partitioned prefill and 8 partitioned decode steps (both
    through ``step_fn_for``, greedy tokens on each side) against
    ``prefill`` + ``decode_step``: tokens, logits and caches bit for bit,
    K4 / K5 launches equal, no plain call; K5's partial mode against its
    plain version at Qwen3-32B decode_32k's shard (8, 64 / 8, 2048, 128)
    bf16, group 1 and float32, rows whose shard is full, partial or empty
    (``out`` within float32's 5e-5, ``lse`` within 1e-4, the empty rows
    0 / -inf); 16 shards of one 32,768-row cache combined against the
    whole-cache K5 within its bf16 tolerance; both modes, the plain
    version and SDPA timed at the shard shape; then rank 0 of a fake (16,
    16) world at Qwen3-32B's width, 2 layers, decode_32k's 128 x 32,768
    (8 rows x 2,048 positions a rank): FLOPs and collective calls on the
    card equal the ``meta`` count, the peak within 3 %, one K5 partial
    launch a layer over 2,048 positions;
14p. partition MoE — the partitioned MoE and MLA + MoE steps (the experts
    split on ``model`` and gathered one layer at a time on the data axes,
    MLA split by heads, its latent cache by the sequence): on a (1, 1)
    mesh in a world of one NCCL rank, Qwen3-MoE and DeepSeek-V3 (without
    its MTP block) at full width, 1 layer, 2 x 512 prompts, the
    partitioned prefill and 8 partitioned decode steps (greedy tokens on
    each side) against ``prefill`` + ``decode_step`` bit for bit (tokens,
    logits, caches), and for Qwen3-MoE one partitioned train step against
    the single-device step within 1e-4 / 5e-4; K4 / K5 / K6 launches
    equal, no plain call; then rank 0 of a fake (16, 16) world at both
    models' full width, 2 layers (+ DeepSeek-V3's MTP block), a train step
    on 16 x 4,096 of train_4k's rows and a decode step on decode_32k's
    128 x 32,768: FLOPs and collective calls on the card equal the
    ``meta`` count, the peak within 3 %, launches equal the meta calls;
14q. partition SSM — the partitioned Mamba2 and Zamba2 steps (the SSD
    heads split on ``model`` where they divide it, else the mixer whole
    there; Zamba2's shared block by the dense rules; the decode's state
    whole on ``model``, its K/V blocks as ``cache_sharding`` lays them
    out): on a (1, 1) mesh in a world of one NCCL rank, Zamba2-2.7B at
    full width, 6 layers (one super-block), and Mamba2-130M at full width
    and depth, 2 x 512 prompts, the partitioned prefill, 8 decode steps
    and one train step against the single-device path bit for bit, K4 /
    K5 / K6 / K7 launches equal, no plain call; then rank 0 of a fake (16,
    16) world at Zamba2-2.7B's width, 6 layers: a train step on 16 x
    4,096 of train_4k's rows, a decode step on decode_32k's 128 x 32,768
    (the sequence on ``model``) and one on long_500k's 1 x 524,288 (the
    sequence on ``data``, the KV heads on ``model``): FLOPs and collective
    calls on the card equal the ``meta`` count, the peak within 3 %,
    launches equal the meta calls;
15. timings — CUDA-event times of K1/K2 and their plain versions (10 live
    lanes a row); the fused kernel's device time per call and per group
    step on the main path's first 50 single-job calls and first 10
    chained bursts, beside its plain loop's and its bound; the first 10
    chained burst admissions' wall times and device busy shares; the RD step kernel's device time per launch on a profiled
    chain of the main path's jobs, the chain's busy share, and kernel
    against plain iteration over the same 200 iterations.
16. observed serve (run after 10., on its weights) — one Qwen1.5-4B
    engine serves 4 requests under ``observe()`` with ``debug=True`` (the
    buffer guard armed): the tokens equal the unobserved, unguarded
    engine's, ``device.serve-decode.calls`` equals the decode steps;
17. contracts — each of the eight scheduler kernel contracts at every geometry the
    run launched: its shared memory and threads equal the block the
    wrapper launched with, its static shared memory the compiled
    kernel's, within the card's opt-in shared memory, which equals
    kernelcheck's default budget; then ``python -m
    repro_torch.analysis.kernelcheck`` in-process, exit 0.

Then the ``new_phases`` line (6e-6g, 16 and 17's walls; 14a-14b's
walls are on the ``moe_phases`` line; 7a, 14c and 14d's on the
``slice11_phases`` line; 14e-14h's on the ``slice12_phases`` line;
14i-14k's on the ``slice13_phases`` line; 14l's on the
``slice14_phases`` line; 14m's on the ``slice15_phases`` line; 14n's on
the ``slice16_phases`` line; 14o's on the ``slice17_phases`` line; 14p's
on the ``slice18_phases`` line; 14q's on the ``slice19_phases`` line), the
``kernels``
summary line (the ``wf_fused`` and ``rd_step`` rows count 6a-6g's and
14m's launches too; ``decode_attention_partial`` is K5's partial mode,
its launches 14o's), the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``.  Each phase's line carries ``t_s``,
the seconds since the start.  The host-only references of 5 (the host
``wf`` schedules), 6c (OBTA, NLIP, the host ``rd``) and 14m (the
examples' CPU side) run in one worker process beside the card's phases,
which is stopped however the run ends.  The script needs a CUDA device and the repository's ``src/``
beside it.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import datetime
import faulthandler
import functools
import gc
import io
import itertools
import json
import math
import multiprocessing
import re
import os
import runpy
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro_torch import obs  # noqa: E402
from repro_torch.analysis import kernelcheck  # noqa: E402
from repro_torch.analysis.contracts import CONTRACTS  # noqa: E402
from repro_torch.backend import set_backend  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.core import AssignmentProblem, TaskGroup, water_filling  # noqa: E402
from repro_torch.core import commit_busy, nlip, obta, rd_torch, wf_torch  # noqa: E402
from repro_torch.core.rd import host_commit_walk, replica_deletion  # noqa: E402
from repro_torch.core.rd_plus import rebalance_1opt  # noqa: E402
from repro_torch.core.wf_torch import water_filling_torch  # noqa: E402
from repro_torch.data import LocalityAwareLoader, ShardStore  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import decode_attention as dak  # noqa: E402
from repro_torch.kernels import flash_attention as fak  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import rd as rdk  # noqa: E402
from repro_torch.kernels import rmsnorm as rnk  # noqa: E402
from repro_torch.kernels import ssd_scan as ssk  # noqa: E402
from repro_torch.kernels import waterlevel as wl  # noqa: E402
from repro_torch.models import decode_step, init_params, prefill  # noqa: E402
from repro_torch.models import ffn as moe_ffn  # noqa: E402
from repro_torch.runtime import (  # noqa: E402
    ControlPlane,
    ResilienceConfig,
    SchedulingEngine,
    ServerEvent,
    make_policy,
)
from repro_torch.obs.trace import parse_chrome_trace  # noqa: E402
from repro_torch.placement import PlacementStore, register_checkpoint  # noqa: E402
from repro_torch.serve import balance_expert_replicas, replica_placement  # noqa: E402
from repro_torch.serve.engine import (  # noqa: E402
    ReplicaRouter,
    Request,
    RoutedServePool,
    ServeEngine,
    make_prefill_step,
)
from repro_torch.train import AdamWConfig as TrainAdamWConfig  # noqa: E402
from repro_torch.train import TrainState, make_train_step, train_state_init  # noqa: E402
from repro_torch.train.optim import tree_leaves as ckpt_leaves  # noqa: E402
from repro_torch.train.step import loss_fn as train_loss_fn  # noqa: E402
from repro_torch.train.step import shard_train_state  # noqa: E402
from repro_torch.train.compress import init_error_state, make_compressed_grad_fn  # noqa: E402
from repro_torch.train.optim import adamw_init, param_tree  # noqa: E402
from repro_torch.launch import dryrun as dry  # noqa: E402
from repro_torch.launch import roofline as roof  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.launch.specs import step_fn_for  # noqa: E402
from repro_torch.configs.shapes import ShapeSpec  # noqa: E402
from repro_torch.models.moe_sharded import moe_apply_sharded, moe_route_sharded  # noqa: E402
from repro_torch.parallel import gather_state, set_mesh  # noqa: E402
from repro_torch.parallel import partition  # noqa: E402
from repro_torch.traces import (  # noqa: E402
    generate,
    load_batch_task_csv,
    overload_client,
    rack_failure_timeline,
    replay_client,
    saturation_qps,
)

# main-path configuration: ~4,000 machines as in Alibaba's
# cluster-trace-v2018, the paper segment's per-server load kept
# (113,653 tasks per 100 servers, scaled to 4096 servers)
M_SERVERS = 4096
N_JOBS = 1000
TOTAL_TASKS = 4_655_227
# the main path under ocwf-acc runs the trace's first OCWF_JOBS jobs (it
# re-plans every pending job at each arrival: the whole trace took 84 s
# on the card's host, beside 80 s for its host reference)
OCWF_JOBS = 300

# the RD main path: the trace's first RD_JOBS jobs (three same-slot bursts)
# through the chain, then its first burst one arrival at a time
RD_JOBS = 18
RD_PER_ARRIVAL_JOBS = 5
# the chain profiled for device time: jobs 2-3 of the third burst (the
# shortest), ~1,600 strips — the profiler's per-event cost makes a whole
# burst (8,000 strips, ~2M events) take minutes
RD_PROFILED_BURST = 2
RD_PROFILED_JOBS = slice(1, 3)

KERNEL_WIDTHS = (1, 100, 4096, 16384, 32768)
KERNEL_BATCHES = (1, 8)
KERNEL_CASES = ("random", "ties", "one-available", "demand0", "boundary", "above-big")
TIMED = ((4096, 1), (16384, 1), (32768, 1), (4096, 8))
# the fused water-filling kernel against its plain loop: groups of 1 to
# 4096 live lanes and the edge cases, K groups, B problems, M servers
FUSED_LIVE = {"live-1": (1, 1), "live-8-12": (8, 12), "live-40-64": (40, 64),
              "live-200": (200, 200), "live-4096": (4096, 4096)}
FUSED_CASES = (*FUSED_LIVE, "ties", "demand0", "one-available", "boundary", "at-big",
               "reach-big")
FUSED_WIDTHS = (2, 4096, 32768)
FUSED_KS = (1, 8)
FUSED_BS = (1, 8)
# the main path's first FUSED_TIMED_SINGLES single-job calls and first
# FUSED_TIMED_CHAINS chained bursts timed, kernel against plain loop, and
# the chained admission's first FUSED_TIMED_CHAINS bursts: the profiler's
# per-event cost made the plain loop over 200 bursts (~500k kernel
# events a pass) take most of the phase's 221-303 s
FUSED_TIMED_SINGLES = 50
FUSED_TIMED_CHAINS = 10
# the RD step kernel against its plain iteration, in lockstep, besides the
# main path's first job
RD_CASES = ("random", "ties", "no-candidates", "quota-past-total", "int32-extremes",
            "free-slot-shortage", "width-33", "width-48", "width-64", "max-geometry")
# a problem with groups of RD_WIDE_GROUPS[0]-[1] of the 4096 servers
RD_WIDE_GROUPS = (40, 64)
# deletion iterations timed on the profiled chain's first job, kernel
# against plain iteration, from the same state
RD_TIMED_ITERATIONS = 200

# the control plane on the same trace: the event loop over all of it, and
# ControlPlane(rd_torch, setf) over its first RD_JOBS jobs (every rescan
# re-runs RD for each outstanding job)
# faults_online: the trace's first ONLINE_JOBS jobs replayed at ONLINE_RHO
# of the saturation rate, under three drills: a RACK_SERVERS rack down
# from RACK_FAIL_AT to RACK_RECOVER_AT with retry (recovered before a
# retry's third backoff ends); STRAGGLERS random servers slowed
# STRAGGLER_FACTOR-fold every STRAGGLER_EVERY slots, for as long, with
# stealing and speculation; and the jobs re-timed to ONLINE_OVERLOAD_RHO
# (past saturation) with admission control
ONLINE_JOBS = 200
ONLINE_RHO = 0.5
ONLINE_OVERLOAD_RHO = 1.5
RACK_SERVERS = tuple(range(128))
RACK_FAIL_AT, RACK_RECOVER_AT = 30, 50
STRAGGLERS, STRAGGLER_EVERY, STRAGGLER_FACTOR = 64, 10, 6.0
# exact: the first EXACT_PROBLEMS arrival problems of the wf_torch fifo
# plane against OBTA and NLIP, and through the host rd, rd_torch and
# rd_plus; rd_plus through the plane on the first RD_PLUS_JOBS jobs (one
# device RD per arrival, ~10,500 K3 launches and ~0.43 s each on the card:
# 60 jobs took 25.85 s, so the whole trace would take ~7 minutes); 100
# problems and 60 jobs took 82 s of the script's 1,200 s limit
EXACT_PROBLEMS = 40
RD_PLUS_JOBS = 30
# plane_serve: two Mamba2-130M replicas behind a wf_torch router serve the
# SSM traffic (8 requests, 32-128 prompt tokens, 16 new), one request a
# slot from the arrival of job PLANE_SERVE_FIRST of the first
# PLANE_SERVE_JOBS jobs the plane schedules meanwhile
PLANE_SERVE_ARCH = "mamba2-130m"
PLANE_SERVE_JOBS = 50
PLANE_SERVE_FIRST = 10

# observed_main_path: the fifo main path again under a session whose ring
# holds the whole trace, and ControlPlane(rd_torch, setf) on the first
# OBSERVED_RD_JOBS jobs under one
OBSERVED_TRACE_CAPACITY = 1 << 20
OBSERVED_RD_JOBS = 5
# csv_replay: a headerless batch_task.csv in cluster-trace-v2017's published
# 8-column schema, drawn from the seed at the paper's segment size (Sec.
# V-A: 250 jobs, 113,653 task instances; 1-8 task groups a job, ~2 % of the
# rows not Terminated), replayed in 4096-row chunks on the trace's
# published 1,300 machines; wf_torch over every job, rd_torch over the
# first CSV_RD_JOBS
CSV_JOBS = 250
CSV_TASKS = 113_653
CSV_GROUPS = (1, 8)
CSV_OFF_STATUS = 0.02
CSV_SERVERS = 1300
CSV_CHUNK_ROWS = 4096
CSV_SMALL_CHUNK = 97  # a second replay in many chunks
CSV_RD_JOBS = 10
# moe_balance: DeepSeek-V3's routed experts (256, top-8) on its prefill
# deployment unit (technical report Sec. 3.4: 32 GPUs, EP32), two replicas
# an expert; 4 x 2048 tokens a step, MOE_STEPS steps, Zipf expert loads;
# identical devices (μ = 1: the time unit is one token's expert pass), the
# queue drains by a device's even share of a step between steps
MOE_EXPERTS = 256
MOE_TOP_K = 8
MOE_DEVICES = 32
MOE_REPLICAS = 2
MOE_TOKENS = 4 * 2048
MOE_STEPS = 50
MOE_ZIPF = 1.1
# observed_serve: one Qwen1.5-4B engine (the serve main path's weights)
# serving 4 requests of 16-64 prompt tokens and 16 new, under a session
# with the buffer guard armed, against the same requests without either
# (prompts of 32-128 took 34-47 s: fed token by token, they set its time)
OBSERVED_SERVE_REQUESTS = 4
OBSERVED_SERVE_PROMPT = (16, 64)
OBSERVED_SERVE_NEW = 16

# the serving main path: Qwen1.5-4B (the launcher's default arch) at full
# width, two replicas of 4 slots and 1024 positions each
SERVE_ARCH = "qwen1.5-4b"
SERVE_REPLICAS = 2
SERVE_SLOTS = 4
SERVE_MAX_LEN = 1024
# 8 requests (16 before the Mamba2 phases): 16 took the whole script to
# 962 s on a slow host
SERVE_REQUESTS = 8
SERVE_PROMPT = (32, 256)  # prompt lengths drawn in [32, 256]
SERVE_NEW = 32
# the prefill path: 4 prompts of 2048 tokens, cache room for 128 more
PREFILL_BATCH = 4
PREFILL_LEN = 2048
PREFILL_MAX_LEN = 2176
# largest |prefill-over-S+1 - decode-from-prefill| logit over the logits'
# largest magnitude, in bf16 over 40 layers (set from measured runs)
PREFILL_REL_TOL = 0.05
# kernel-vs-plain tolerances: float32 sums in another order; bfloat16 2e-2
# plus one bfloat16 rounding step of the value
MODEL_TOL = {"float32": (5e-5, 0.0), "bfloat16": (2e-2, 2**-7)}
# K5 / K6 cases in bf16 are held a second time, against the plain
# version in float32 on the same inputs, within this share of its
# largest output: the kernel rounds its output (2**-9) and, on the
# tensor cores, P to bf16; the last key masked off moves an output of
# the ramp inputs (_ramp) past this, though by less than MODEL_TOL's atol
BF16_F32_REL = 2**-6

# the Mamba2 family at full width: Mamba2-130M through one ServeEngine,
# Zamba2-2.7B behind the same two-replica pool as the dense path; both
# 4 slots x 1024 positions, 8 requests of 32-128 prompt tokens, 16 new each
SSM_ARCHS = ("mamba2-130m", "zamba2-2.7b")
SSM_REPLICAS = {"mamba2-130m": 1, "zamba2-2.7b": SERVE_REPLICAS}
# Zamba2-2.7B's serving, decode profile and prefill run 24 of its 54
# layers (4 of its 9 super-blocks, full width): the depth is cut so that
# the script, with the training and VLM phases, stays well inside its
# time limit; K7's and K6's checks and timings keep the published shapes
SSM_LAYERS = {"mamba2-130m": None, "zamba2-2.7b": 24}
SSM_REQUESTS = 8
SSM_PROMPT = (32, 128)
SSM_NEW = 16
# the SSM prefill path: 4 x 2048 tokens, cache room for 256 more; the
# continuation check prefills the first 1792 tokens and decodes the other
# 256 one step at a time, against the prefill over all 2048
SSM_PREFILL_MAX_LEN = 2304
SSM_CONT_PREFIX = 1792
# largest |continued - prefilled| last-position logit over the logits'
# largest magnitude.  In bf16 (the served dtype) 5 % was the bound set
# before the first measurement, and Zamba2-2.7B missed it (6.1 %) while a
# bf16 prefill alone lies 7.7 % from the float32 one over the same tokens:
# bf16 rounding, not the handoff.  So the handoff is held in float32 (the
# same weights upcast) to the bound set before measuring it; bf16 is
# reported beside its own distance from float32, with every argmax whose
# top-2 gap is clear agreeing.
SSM_CONT_REL_TOL = 0.05
SSM_CONT_F32_TOL = 1e-3
# K7 against its plain version at the model's chunk (256): |err| <= atol +
# rtol * max|plain| per output.  The plain version's prefix sums of dt*a
# run over 256-row chunks to |cum| ~ 200, where an fp32 ulp is 1.5e-5 of
# every decay factor; the kernel's over 64-row tiles.  Measured on the CPU
# against float64: 7.4e-6 * max|y| for the plain version, 1.1e-6 for a
# 64-row chunk.  bf16 inputs are read as the same fp32 values by both.
SSD_TOL = (5e-5, 3e-5)
SSD_TILE = 64  # the kernel's rows per tile (csrc/ssd_scan.cu kQ)
SSD_RAGGED = (1, 63, 65, 2047)  # sequence lengths around the 64-row chunks

# the MoE family (Qwen3-MoE-235B-A22B) and the MLA + MoE family
# (DeepSeek-V3-671B) at their published widths, bf16, seeded random
# weights; only depth is cut, to fit one 80 GB card: Qwen3-MoE 4 of 94
# layers (~4.98 GB a layer + a 1.24 GB embedding, two replicas sharing
# the weights), DeepSeek-V3 2 of 61 and no MTP block (~23.0 GB a layer +
# 1.85 GB).  Qwen3-MoE serves the dense cell's traffic through the same
# two-replica wf_torch pool; DeepSeek-V3 one engine, 6 requests of 32-128
# prompt tokens, 16 new each.  Then each model's prefill at the published
# capacity factor (4 x 2048 tokens; 2 x 2048 for DeepSeek-V3, whose MLA
# logits (B, 128, S, S) fp32 are 4.3 GB at 2 x 2048) and the prefill ->
# decode handoff at capacity factor E / k (cap = N: nothing drops) on 4 x
# 512 and 2 x 256 tokens (the no-drop (E, N, d) expert buffers scale with
# N: at 2 x 2048 DeepSeek-V3's would be 15 GB each beside 48 GB of
# weights).  In bf16 (the served dtype) the handoff missed the dense
# check's 5 % by far (28 % on Qwen3-MoE, every argmax agreeing): the
# router's top-k is discontinuous, and bf16 rounding between the decode
# and the prefill path moves tokens across the 8th expert's boundary.  So
# it is held in float32 (the same weights upcast; DeepSeek-V3 on its
# first layer only, since two layers in float32 are 96 GB) to
# MOE_HANDOFF_F32_TOL; bf16 is reported beside the bf16 prefill's own
# distance from the float32 one, with every clear argmax agreeing
MOE_ARCHS = ("qwen3-moe-235b-a22b", "deepseek-v3-671b")
MOE_LAYERS = {"qwen3-moe-235b-a22b": 4, "deepseek-v3-671b": 2}
MOE_SERVE = {  # replicas, requests, prompt lengths, new tokens
    "qwen3-moe-235b-a22b": (SERVE_REPLICAS, SERVE_REQUESTS, SERVE_PROMPT, SERVE_NEW),
    "deepseek-v3-671b": (1, 6, (32, 128), 16),
}
MOE_PREFILL_BATCH = {"qwen3-moe-235b-a22b": 4, "deepseek-v3-671b": 2}
MOE_HANDOFF = {"qwen3-moe-235b-a22b": (4, 512), "deepseek-v3-671b": (2, 256)}
MOE_F32_LAYERS = {"qwen3-moe-235b-a22b": 4, "deepseek-v3-671b": 1}
MOE_HANDOFF_F32_TOL = 1e-3
MOE_BUDGET_S = 90  # this slice's phases, together

# K5 and K6 past their earlier ceilings (attention_widths): K6's widths,
# one on the tensor cores in bf16 (96), two on the any-width kernel
WIDTH_K6 = (256, 96, 72)

# LLaVA-NeXT-Mistral-7B at full width and depth (32 layers, ~7.2 G
# parameters, ~14.5 GB in bf16, seeded weights; the vision tower stubbed
# as the reference stubs it: 576 seeded patch embeddings a sequence):
# 4 sequences of 576 patches + 64 tokens prefilled, then 32 decode steps
VLM_ARCH = "llava-next-mistral-7b"
VLM_BATCH = 4
VLM_PROMPT = 64
VLM_STEPS = 32
VLM_PATCH_STD = 0.02  # the patch embeddings' scale: the token embeddings' init std

# training on one card (train): Qwen1.5-4B at full width (d 2560, vocab
# 151,936), 4 of its 40 layers, batch 4 x 1024; Mamba2-130M whole, 4 x
# 2048; bf16 weights, AdamW with bf16 moments, 20 steps on one batch from
# the locality-aware loader (the loss must fall, as the reference's
# test_train_step_memorizes_fixed_batch); step 1's gradients through the
# kernels' Functions against the same model with the plain versions in
# its forward: in bf16 within TRAIN_GRAD_TOL (the global norm's relative
# difference, and each leaf's and the whole gradient's relative L2
# distance: bf16 rounds differently on the two paths, e.g. K6 multiplies
# V by P rounded to bf16), and, to tell rounding from a fault, the same
# model upcast to float32 within TRAIN_GRAD_TOL_F32 (the kernels' float32
# routes against fp32 plain math); then the train state through
# CheckpointManager and register_checkpoint
TRAIN_MODELS = {"qwen1.5-4b": (4, 4, 1024), "mamba2-130m": (None, 4, 2048)}
TRAIN_STEPS = 20
TRAIN_OPT = dict(lr=1e-3, warmup_steps=2, total_steps=TRAIN_STEPS, moment_dtype="bfloat16")
TRAIN_LOSS_DROP = 0.3
# (the bf16 leaf limit: Mamba2's dt_bias leaf, 24 sums over 8,192 tokens
# with cancellation, lies 7.5e-2 from the plain path's on an H100 while
# the float32 copy agrees to 3.7e-5: the gap is bf16 rounding)
TRAIN_GRAD_TOL = {"global_norm": 1e-2, "leaf": 1.5e-1, "whole": 5e-2}
TRAIN_GRAD_TOL_F32 = {"global_norm": 1e-3, "leaf": 1e-3, "whole": 1e-3}
SLICE11_BUDGET_S = 150  # attention_widths, vlm_serve and train together

# Whisper-medium (encdec) at full width and depth (24 encoder + 24 decoder
# layers, d 1024, 16 query over 16 KV heads of 64, vocab 51,865, 0.96 G
# parameters, 1.9 GB in bf16, seeded weights; the conv frontend stubbed
# as the reference stubs it: 1500 seeded N(0, 1) frame embeddings a
# sequence).  Serving: 4 sequences, a 64-token prompt prefilled, then 32
# decode steps; a float32 copy of 2 + 2 layers through the kernels
# against the plain versions within ENCDEC_F32_TOL.  Training: 4 x (1500
# frames + 448 tokens; 448 is Whisper's published decoder context),
# ENCDEC_TRAIN_STEPS steps.  Then the port's train driver on Mamba2-130M:
# LAUNCH_STEPS[0] steps (an async save at 50, the final one at the end),
# then again to LAUNCH_STEPS[1], resuming
ENCDEC_ARCH = "whisper-medium"
ENCDEC_BATCH = 4
ENCDEC_PROMPT = 64
ENCDEC_STEPS = 32
ENCDEC_F32_LAYERS = 2
ENCDEC_F32_STEPS = 4
ENCDEC_F32_TOL = 1e-4
ENCDEC_TRAIN_TOKENS = 448
ENCDEC_TRAIN_STEPS = 20
ENCDEC_GRAD_BATCH = 2  # the step-1 gradient check's sequences (of the 4 trained)
LAUNCH_ARCH = "mamba2-130m"
LAUNCH_STEPS = (60, 70)
SLICE12_BUDGET_S = 75  # encdec_kernels, encdec_serve, encdec_train, launch_train
# the parallel/ slice, in a world of one NCCL rank on a (1, 1) (data, model)
# mesh: the sharded train step (phase_train's Qwen1.5-4B cut: 4 of 40
# layers, 4 x 1024), the expert-parallel MoE (one Qwen3-MoE-235B-A22B
# layer's FFN at full width) and int8 gradient compression
PARALLEL_ARCH = "qwen1.5-4b"
PARALLEL_MODEL = (4, 4, 1024)  # layers, batch, sequence
PARALLEL_STEPS = 3
PARALLEL_TOL = {"loss": 1e-4, "params": 5e-4}  # tests/test_distributed.py's limits
MOE_SHARDED_ARCH = "qwen3-moe-235b-a22b"
MOE_SHARDED_TOKENS = (4, 1024)
MOE_SHARDED_CF = 1.25
COMPRESS_STEPS = 300
SLICE13_BUDGET_S = 60  # parallel_train, moe_sharded, compress
SLICE14_BUDGET_S = 60  # dryrun_check
SLICE15_BUDGET_S = 60  # examples: the four scripts on the card and on the CPU
SLICE16_BUDGET_S = 60  # partition_check
PARTITION_ARCH = "qwen1.5-4b"
PARTITION_MODEL = (2, 2, 1024)  # layers, batch, sequence
PARTITION_STEPS = 2
PARTITION_FAKE_ARCH = "qwen3-32b"
PARTITION_FAKE = (2, 256, 4096)  # layers, and train_4k's global batch and sequence
PARTITION_FAKE_MESH = (16, 16)
PARTITION_PEAK_TOL = 0.03
SLICE17_BUDGET_S = 60  # partition_decode
PARTITION_DECODE_STEPS = 8
PARTITION_DECODE_FAKE = (2, 128, 32768)  # layers, and decode_32k's global batch and cache
K5_SHARD = (8, 64, 8, 2048, 128)  # B, H, Hkv, T, hd: Qwen3-32B decode_32k's block on (16, 16)
K5_SHARDS = 16  # the model axis of pod16x16: one 32,768-row cache's shards
K5_LSE_TOL = 1e-4  # |lse - plain lse| (natural log units), fp32 math on both sides
SLICE18_BUDGET_S = 60  # partition_moe
# the (1, 1) mesh's MoE runs: arch -> layers, batch, sequence (one layer:
# a Qwen3-MoE layer's 128 experts are 4.8 GB in bf16, a DeepSeek-V3
# layer's 256 are 22.5 GB, and the train step holds the state with its
# fp32 gradients and the new state beside it)
PARTITION_MOE_ONE_RANK = {"qwen3-moe-235b-a22b": (1, 2, 512), "deepseek-v3-671b": (1, 2, 512)}
PARTITION_MOE_TRAINS = ("qwen3-moe-235b-a22b",)  # DeepSeek-V3 does not train on one card
# the fake (16, 16) world's cells: 2 layers (+ DeepSeek-V3's MTP block);
# train_4k's 256 rows cut to 16 (one a data rank) of 4,096; decode_32k's
# 128 x 32,768 (8 rows x 2,048 positions a rank)
PARTITION_MOE_FAKE = {"train": (2, 16, 4096), "decode": (2, 128, 32768)}
SLICE19_BUDGET_S = 45  # partition_ssm
# the (1, 1) mesh's SSM runs: arch -> layers (None: all), batch, sequence;
# Zamba2-2.7B cut to one super-block (its shared block and 6 Mamba2 layers)
PARTITION_SSM_ONE_RANK = {"zamba2-2.7b": (6, 2, 512), "mamba2-130m": (None, 2, 512)}
# the fake (16, 16) world's Zamba2-2.7B cells, 6 layers: train_4k's 256 rows
# cut to 16 (one a data rank) of 4,096; decode_32k's 128 x 32,768 (8 rows x
# 2,048 positions a rank, the sequence on model); long_500k's 1 x 524,288
# (the row whole, the sequence on data: 32,768 positions and 2 KV heads a rank)
PARTITION_SSM_ARCH = "zamba2-2.7b"
PARTITION_SSM_FAKE = {"train_4k": ("train", 6, 256 // 16, 4096),
                      "decode_32k": ("decode", 6, 128, 32768),
                      "long_500k": ("decode", 6, 1, 524288)}
EXAMPLES = ("quickstart", "fault_tolerance", "serve_moe_balanced", "train_locality")
# the training example's two calls at its default 8 x 128 tokens a step:
# 26 steps failing data host 3 at step 13, then resumed to 51 (the async
# save at 50) with the compression demo
EXAMPLE_CALLS = {"train_locality": (["--steps", "26", "--fail-host", "3"],
                                    ["--steps", "51", "--compress"])}
EXAMPLE_LOSS_TOL = 1e-3  # card against CPU, float32, at each printed step
EXAMPLE_CPU_THREADS = 2  # the host worker's threads for the examples' CPU side
DRYRUN_ARCHS = {"qwen1.5-4b": 2, "mamba2-130m": 2}  # arch: layers (full width)
DRYRUN_BATCH = (2, 1024)  # sequences, tokens (decode: one token against a 1024-row cache)
DRYRUN_TIMED = 3  # timed runs of each step after the counted one; the median is kept
# meta peak_bytes against torch.cuda.max_memory_allocated over the step:
# the tracker counts storage bytes as created; the caching allocator
# rounds each block up to 512 bytes, and the step's first cuBLAS call on a
# new stream may allocate its workspace
DRYRUN_PEAK_TOL = 0.10
NCCL_TIMEOUT_S = 120  # a collective of the one-rank world that hangs fails instead
# past this wall, every thread's stack goes to stderr (the run itself is
# stopped at 1,200 s from outside): where a slow or hung run was
WATCHDOG_S = 1100

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, the 32-bit rate
# outside the tensor cores (the table's fp32 entry; the scheduler
# kernels' arithmetic is 32-bit integer, which issues no faster), and the
# dense bf16 tensor-core rate
HBM_BYTES_PER_S = 3.35e12
PEAK_32BIT_OPS_PER_S = 67e12
PEAK_BF16_FLOPS = 989e12
L2_BYTES = 50 * 2**20  # the H100 SXM's L2
OPS_PER_COMPARE_EXCHANGE = 3  # one 64-bit compare, two selects
OPS_PER_LANE = 12  # scans, ceiling division, segment test, caps, clamp


T_START = time.perf_counter()


def emit(obj: dict) -> None:
    """One JSON line; a phase's line carries ``t_s``, the seconds since the
    script started, so the whole run's time splits by phase."""
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - T_START}
    print(json.dumps(obj), flush=True)


def nvidia_smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True,
        capture_output=True,
        text=True,
    ).stdout.strip().splitlines()[0]


# ---- bounds ------------------------------------------------------------------


def compare_exchanges(n: int) -> int:
    log = n.bit_length() - 1
    return n // 2 * log * (log + 1) // 2


def _pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def wl_step_ops(n: int, live: int) -> int:
    """32-bit operations of one row step on this run's data: a sorting
    network over the next power of two of the lanes that are not BIG (the
    rest form the BIG run, already in order), then the scans, ceiling
    divisions and clamps over all n lanes."""
    return OPS_PER_COMPARE_EXCHANGE * compare_exchanges(_pow2(live)) + OPS_PER_LANE * n


def card_bound_ms(n: int, live: list[int]) -> tuple[float, str]:
    """Least time for K1/K2 on these rows on the whole card: each input read
    and each output written once over HBM, or the 32-bit operations the
    rows' live lanes need over the card's peak rate, whichever is larger."""
    nbytes = len(live) * (16 * n + 8)  # b, w in; take, idx out; demand, level
    ops = sum(wl_step_ops(n, k) for k in live)
    return _bound(nbytes, ops, PEAK_32BIT_OPS_PER_S)


def fused_bound_ms(calls: list) -> tuple[float, str]:
    """Least time per fused launch over ``calls`` (each the argument tuple
    of one launch): busy and each problem's μ (4M bytes each), the masks
    (K·M bytes) and the demands read once, the alloc rows (4·K·M bytes),
    the levels and Φ (and the chain's busy after the burst) written once,
    over HBM; or the row steps' 32-bit operations on these masks (see
    :func:`wl_step_ops`) over the card's peak rate."""
    nbytes = ops = 0
    for busy, mu, masks, demands in calls:
        p, k, m = masks.shape
        nbytes += (4 * busy.numel() + 4 * mu.numel() + masks.numel() + 4 * demands.numel()
                   + 4 * p * k * m + 4 * p * k + 4 * p + (4 * m if busy.dim() == 1 else 0))
        live = masks.sum(-1).reshape(-1).tolist()
        ops += sum(wl_step_ops(wl.n_lanes_for(m), int(x)) for x in live)
    return _bound(nbytes / len(calls), ops / len(calls), PEAK_32BIT_OPS_PER_S)


def rd_step_bytes(c_slots: int, row_ids: int, m_servers: int) -> int:
    """Bytes one RD iteration must move: the holder rows and the slots'
    size, count, group and hash read once (C * A * 4 + 20 * C), the
    server vectors load, multi, busy_est, busy0, mu and the target flags
    read once (21 * M); its writes (one server's lanes and the movers'
    rows) are a few hundred bytes and left out."""
    return 4 * c_slots * row_ids + 20 * c_slots + 21 * m_servers


# ---- inputs ------------------------------------------------------------------


def padded_rows(rng: np.random.Generator, m: int, bsz: int, case: str):
    """Pre-masked, padded (B, n_lanes) rows as the wf_torch path builds
    them; every row keeps one available lane with positive capacity."""
    busy = rng.integers(0, 25, (bsz, m))
    mu = rng.integers(0, 6, (bsz, m))
    mask = rng.random((bsz, m)) < 0.6
    demand = rng.integers(0, 12 * m + 50, bsz)
    rows = np.arange(bsz)
    if case == "ties":
        busy = rng.integers(0, 3, (bsz, m))
    elif case == "one-available":
        mask[:] = False
        mask[rows, rng.integers(0, m, bsz)] = True
    elif case == "demand0":
        demand[:] = 0
    elif case == "boundary":  # busy just under the BIG sentinel
        busy[:, 0] = wl.BIG - rng.integers(1, 1000, bsz)
        mu[:] = 1
        mask[:] = True
        demand = rng.integers(0, 50, bsz)
    elif case == "above-big":  # available lanes at BIG and past it
        pick = rng.random((bsz, m))
        busy = np.where(pick < 0.2, wl.BIG + rng.integers(0, 40, (bsz, m)), busy)
        busy = np.where((pick >= 0.2) & (pick < 0.3), wl.BIG, busy)
        mu = np.maximum(mu, 1)
        demand = rng.integers(0, 4 * m + 10, bsz)
    dead = ~(mask & (mu > 0)).any(axis=1)
    pick = rng.integers(0, m, bsz)
    mask[rows[dead], pick[dead]] = True
    mu[rows[dead], pick[dead]] = np.maximum(1, mu[rows[dead], pick[dead]])
    n = wl.n_lanes_for(m)
    b = np.full((bsz, n), wl.BIG, np.int32)
    w = np.zeros((bsz, n), np.int32)
    b[:, :m] = np.where(mask, busy, wl.BIG)
    w[:, :m] = np.where(mask, mu, 0)
    dev = torch.device("cuda")
    return (
        torch.from_numpy(b).to(dev),
        torch.from_numpy(w).to(dev),
        torch.from_numpy(demand.astype(np.int32)).to(dev),
    )


def main_path_rows(rng: np.random.Generator, n: int, bsz: int):
    """Rows shaped like the engine's: 10 of the lanes available."""
    b = np.full((bsz, n), wl.BIG, np.int32)
    w = np.zeros((bsz, n), np.int32)
    for r in range(bsz):
        srv = rng.choice(n, 10, replace=False)
        b[r, srv] = rng.integers(0, 200, 10)
        w[r, srv] = rng.integers(3, 6, 10)
    d = rng.integers(100, 5000, bsz).astype(np.int32)
    dev = torch.device("cuda")
    return tuple(torch.from_numpy(x).to(dev) for x in (b, w, d))


def cuda_ms(fn, iters: int) -> float:
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bursts_of(jobs) -> list[list]:
    by_slot: dict[int, list] = {}
    for j in jobs:
        if j.n_tasks > 0:
            by_slot.setdefault(j.arrival, []).append(j)
    return [by_slot[s] for s in sorted(by_slot)]


# ---- phases ------------------------------------------------------------------


def phase_device() -> dict:
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi("name,power.limit")
    clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    out = {
        "phase": "device",
        "name": name,
        "count": torch.cuda.device_count(),
        "nvidia_smi": smi,
        "max_sm_clock_mhz": clock_mhz,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
    }
    emit(out)
    return out


def phase_build() -> None:
    t0 = time.perf_counter()
    results = _build.build_all()
    seconds = time.perf_counter() - t0
    ptxas = [
        line.strip()
        for r in results
        for line in r.log.splitlines()
        if "registers" in line or "Compiling entry" in line
    ]
    emit({
        "phase": "build",
        "seconds": seconds,
        "libraries": [r.path.name for r in results],
        "built": [r.built for r in results],
        "ptxas": ptxas,
    })


def phase_kernels(seed: int) -> dict[str, int]:
    """Kernel vs plain on identical inputs; returns the max abs error per
    kernel name."""
    rng = np.random.default_rng(seed)
    worst = {"waterlevel": 0, "waterlevel_batch": 0}
    checked = []
    for m in KERNEL_WIDTHS:
        for bsz in KERNEL_BATCHES:
            for case in KERNEL_CASES:
                b, w, d = padded_rows(rng, m, bsz, case)
                got = wl.waterlevel_sorted(b, w, d)
                want = wl.waterlevel_sorted_plain(b, w, d)
                torch.cuda.synchronize()
                err = max(
                    int((g.long() - p.long()).abs().max()) for g, p in zip(got, want)
                )
                name = "waterlevel" if bsz == 1 else "waterlevel_batch"
                worst[name] = max(worst[name], err)
                if err != 0:
                    raise AssertionError(
                        f"kernel disagrees with its plain version: m={m} "
                        f"B={bsz} case={case} max_abs_err={err}"
                    )
                checked.append(f"{m}x{bsz}:{case}")
    emit({
        "phase": "kernels",
        "held": ["waterlevel", "waterlevel_batch"],
        "tolerance": 0,
        "cases": len(checked),
        "widths": list(KERNEL_WIDTHS),
        "batches": list(KERNEL_BATCHES),
        "max_abs_err": worst,
    })
    return worst


def fused_inputs(rng: np.random.Generator, case: str, b: int, k: int, m: int,
                 chain: bool) -> tuple[torch.Tensor, ...]:
    """busy ((M,) in chain mode, else (B, M)), μ (B, M), masks (B, K, M),
    demands (B, K) on the card for one case of FUSED_CASES."""
    lo, hi = FUSED_LIVE.get(case, (8, 12))
    if case == "one-available":
        lo = hi = 1
    busy = rng.integers(0, 3 if case == "ties" else 200, (b, m)).astype(np.int64)
    mu = rng.integers(1, 6, (b, m))
    demands = rng.integers(1, 400, (b, k))
    if case == "demand0":
        demands[:] = 0
    elif case == "boundary":  # busy just under BIG
        busy = wl.BIG - rng.integers(1, 1000, (b, m))
        mu[:] = 1
        demands = rng.integers(1, 50, (b, k))
    elif case == "at-big":  # available lanes at exactly BIG, with capacity
        busy[rng.random((b, m)) < 0.3] = wl.BIG
    elif case == "reach-big":  # eq. 10 lifts levels to and past BIG
        busy = wl.BIG - rng.integers(1, 4, (b, m))
        demands = rng.integers(200, 2000, (b, k))
    masks = np.zeros((b, k, m), bool)
    for i in range(b):
        for g in range(k):
            size = int(rng.integers(min(lo, m), min(hi, m) + 1))
            masks[i, g, rng.choice(m, size, replace=False)] = True
    busy = busy[0] if chain else busy
    dev = torch.device("cuda")
    return (torch.from_numpy(busy.astype(np.int32)).to(dev),
            torch.from_numpy(mu.astype(np.int32)).to(dev),
            torch.from_numpy(masks).to(dev),
            torch.from_numpy(demands.astype(np.int32)).to(dev))


def phase_fused_kernel(seed: int) -> int:
    """The fused water-filling kernel against its plain loop on identical
    inputs, bit for bit, in groups and chain mode; returns the largest
    error (0)."""
    rng = np.random.default_rng(seed + 5)
    worst, n_cases, reached_big = 0, 0, False
    for case in FUSED_CASES:
        for chain in (False, True):
            for m in FUSED_WIDTHS:
                for k in FUSED_KS:
                    for b in FUSED_BS:
                        args = fused_inputs(rng, case, b, k, m, chain)
                        wl.reset_counts()
                        got = (wl.wf_chain if chain else wl.wf_groups)(*args)
                        launched = dict(wl.COUNTS)
                        want = (wl.wf_chain_plain if chain else wl.wf_groups_plain)(*args)
                        torch.cuda.synchronize()
                        err = max(int((g.long() - p.long()).abs().max())
                                  for g, p in zip(got, want))
                        worst = max(worst, err)
                        n_cases += 1
                        reached_big |= case == "reach-big" and bool((want[1] >= wl.BIG).any())
                        if err or launched["plain"] or launched["wf_group_steps"] != b * k:
                            raise AssertionError(
                                f"fused kernel disagrees with its plain loop: case={case} "
                                f"chain={chain} M={m} K={k} B={b} max_abs_err={err} "
                                f"counts={launched}")
    if not reached_big:
        raise AssertionError("the reach-big cases never raised a level to BIG")
    emit({
        "phase": "fused_kernel",
        "held": ["wf_groups", "wf_chain"],
        "against": "wf_groups_plain / wf_chain_plain (the loop over the plain water level)",
        "tolerance": 0,
        "cases": n_cases,
        "case_names": list(FUSED_CASES),
        "widths": list(FUSED_WIDTHS),
        "groups": list(FUSED_KS),
        "problems": list(FUSED_BS),
        "levels_reached_big": reached_big,
        "max_abs_err": worst,
    })
    return worst


def main_path_jobs(jobs: list, ordering: str) -> list:
    """The jobs the main path schedules under ``ordering``: the whole
    trace under fifo, its first OCWF_JOBS jobs under ocwf-acc."""
    if ordering == "fifo":
        return jobs
    return sorted(jobs, key=lambda j: (j.arrival, j.job_id))[:OCWF_JOBS]


def main_path_trace(seed: int) -> list:
    return generate(
        "bursty",
        n_servers=M_SERVERS,
        n_jobs=N_JOBS,
        total_tasks=TOTAL_TASKS,
        seed=seed,
    )


def _fused_launches(counts: dict) -> int:
    return counts["wf_groups"] + counts["wf_chain"]


def host_wf_run(jobs: list, ordering: str) -> tuple:
    """The host ``wf`` schedule of ``jobs`` under ``ordering`` and its wall
    seconds: the reference the main path is held to, computed in the
    host worker (:func:`main`) while the card runs the phases before it."""
    t0 = time.perf_counter()
    host = SchedulingEngine(M_SERVERS, make_policy("wf", ordering)).run(jobs)
    return host, time.perf_counter() - t0


def phase_main_path(seed: int, jobs: list, host_wf: dict) -> tuple[list, dict, dict]:
    """The scheduler under fifo and ocwf-acc, then the batch entry point:
    one fused launch per ``wf_torch`` adapter call, no K1/K2 launch and no
    plain call, schedules identical to the host ``wf`` (``host_wf``: each
    ordering's pending :func:`host_wf_run`).  Returns the bursts, the
    launches, and each ordering's (result, wall seconds)."""
    bursts = bursts_of(jobs)
    launches = {"waterlevel": 0, "waterlevel_batch": 0, "wf_fused": 0, "wf_group_steps": 0}
    runs = {}
    for ordering in ("fifo", "ocwf-acc"):
        run_jobs = main_path_jobs(jobs, ordering)
        n_arrivals = sum(len(b) for b in bursts_of(run_jobs))
        torch.cuda.synchronize()
        wl.reset_counts()
        wf_torch.CALLS["adapter"] = 0
        t0 = time.perf_counter()
        dev = SchedulingEngine(M_SERVERS, make_policy("wf_torch", ordering)).run(run_jobs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(wl.COUNTS)
        calls = wf_torch.CALLS["adapter"]
        host, host_wall = host_wf[ordering].get()
        identical = (
            dev.jct == host.jct
            and dev.makespan == host.makespan
            and dev.failed_jobs == host.failed_jobs
        )
        n_fused = _fused_launches(counts)
        emit({
            "phase": "main_path",
            "ordering": ordering,
            "servers": M_SERVERS,
            "jobs": len(run_jobs),
            "tasks": sum(j.n_tasks for j in run_jobs),
            "bursts": len(bursts_of(run_jobs)),
            "mean_jct": dev.mean_jct,
            "p99_jct": dev.jct_percentile(99),
            "makespan": dev.makespan,
            "failed_jobs": len(dev.failed_jobs),
            "engine_wall_s": wall,
            "mean_overhead_ms": dev.mean_overhead_s * 1e3,
            "launches": counts,
            "adapter_calls": calls,
            "fused_launches_per_arrival": n_fused / n_arrivals,
            "group_steps_per_launch": counts["wf_group_steps"] / max(n_fused, 1),
            "host_wf_wall_s": host_wall,
            "identical_to_host_wf": identical,
            **({} if run_jobs is jobs else {"reduced": {
                "jobs": f"the first {len(run_jobs)} of {len(jobs)} jobs"}}),
        })
        if not identical:
            raise AssertionError(f"{ordering}: wf_torch schedule differs from host wf")
        if n_fused == 0 or counts["plain"] != 0 or n_fused != calls:
            raise AssertionError(f"{ordering}: {n_fused} fused launches for {calls} adapter "
                                 f"calls, counts {counts}")
        if counts["waterlevel"] or counts["waterlevel_batch"]:
            raise AssertionError(f"{ordering}: K1/K2 launched on the main path: {counts}")
        launches["wf_fused"] += n_fused
        launches["wf_group_steps"] += counts["wf_group_steps"]
        runs[ordering] = (dev, wall)

    # the independent-problems entry point over the same bursts
    busy = np.random.default_rng(seed + 1).integers(0, 50, M_SERVERS)
    multi = [b for b in bursts if len(b) > 1]
    torch.cuda.synchronize()
    wl.reset_counts()
    wf_torch.CALLS["adapter"] = 0
    t0 = time.perf_counter()
    for burst in multi:
        problems = [AssignmentProblem(busy=busy, mu=j.mu, groups=j.groups) for j in burst]
        got = wf_torch.water_filling_torch_batch(problems)
        for p, a in zip(problems, got):
            want = water_filling(p)
            if a.alloc != want.alloc or a.phi != want.phi:
                raise AssertionError("water_filling_torch_batch differs from host wf")
    wall = time.perf_counter() - t0
    counts = dict(wl.COUNTS)
    emit({
        "phase": "batch_path",
        "bursts": len(multi),
        "problems": sum(len(b) for b in multi),
        "wall_s": wall,
        "launches": counts,
        "adapter_calls": wf_torch.CALLS["adapter"],
        "identical_to_host_wf": True,
    })
    if (counts["wf_groups"] == 0 or counts["plain"] != 0
            or counts["wf_groups"] != wf_torch.CALLS["adapter"]
            or counts["waterlevel"] or counts["waterlevel_batch"]):
        raise AssertionError(f"batch path went around the fused kernel: {counts}")
    launches["wf_fused"] += counts["wf_groups"]
    launches["wf_group_steps"] += counts["wf_group_steps"]
    return bursts, launches, runs


def _rd_groups(rng: np.random.Generator, m: int, k: int, width: int, size_hi: int):
    return tuple(
        TaskGroup(int(rng.integers(1, size_hi)),
                  tuple(sorted(rng.choice(m, int(rng.integers(1, width + 1)),
                                          replace=False).tolist())))
        for _ in range(k)
    )


def rd_edge_case(seed: int, name: str):
    """(problem, slot capacity or None) of one RD edge case, from a seed."""
    rng = np.random.default_rng(seed + 3 + RD_CASES.index(name))
    m = 64
    busy, mu = rng.integers(0, 40, m), rng.integers(1, 4, m)
    capacity = None
    if name == "random":
        groups = _rd_groups(rng, m, 10, 12, 60)
    elif name == "ties":  # equal busy times, repeated server sets
        busy[:], mu[:] = 0, 2
        groups = _rd_groups(rng, m, 4, 6, 60) * 3
    elif name == "no-candidates":  # single-copy groups only
        groups = tuple(TaskGroup(int(rng.integers(1, 30)), (int(s),))
                       for s in rng.choice(m, 12, replace=False))
    elif name == "quota-past-total":  # quota = load_m, past the multi-copy members
        mu[:] = 1000
        groups = _rd_groups(rng, m, 10, 8, 80) + tuple(
            TaskGroup(int(rng.integers(50, 90)), (int(s),)) for s in range(0, m, 3))
    elif name == "int32-extremes":  # busy_est wraps past INT32_MAX on some servers
        top = np.iinfo(np.int32).max - rng.integers(0, 20, m)
        busy = np.where(rng.random(m) < 0.5, top, rng.integers(0, 20, m))
        groups = _rd_groups(rng, m, 10, 10, 120)
    elif name == "free-slot-shortage":  # 120 classes spawn past 128 slots
        groups = tuple(TaskGroup(int(rng.integers(5, 20)),
                                 tuple(sorted(rng.choice(10, 6, replace=False).tolist())))
                       for _ in range(120))
        capacity = rdk.MIN_LANES
    elif name.startswith("width-"):
        width = int(name.split("-")[1])
        groups = (TaskGroup(12, tuple(sorted(rng.choice(m, width, replace=False).tolist()))),
                  *_rd_groups(rng, m, 5, width, 10))
    else:  # max-geometry: the server and slot ceilings
        m = rdk.RD_MAX_M
        busy, mu = rng.integers(0, 40, m), rng.integers(1, 4, m)
        groups = _rd_groups(rng, m, 6, 16, 40)
        capacity = rdk.RD_MAX_C
    return AssignmentProblem(busy=busy, mu=mu, groups=groups), capacity


def rd_lockstep(st, past_exit: int = 2) -> int:
    """Run both RD loops on ``st`` with the step kernel and the plain
    iteration on a clone, comparing every buffer (spare row and lane
    included) after each iteration, then ``past_exit`` more iterations of
    each loop; returns the iterations, and raises on any difference.  The
    plain iteration and the comparisons (per buffer, the first iteration
    that differed, read once at the end) run as one CUDA graph for each
    loop, captured at this geometry: a replay is the plain version's ~700
    operations without their launches from the host, and counts as one
    call of it."""
    shadow = st.clone()
    names = list(st.buffers())
    dev = st.stop.device
    first = torch.full((len(names),), -1, dtype=torch.int64, device=dev)
    at = torch.zeros((), dtype=torch.int64, device=dev)  # the iteration a replay checks

    def plain(dedup: bool) -> None:
        rdk.rd_step_plain(shadow, dedup)
        other = shadow.buffers()
        differs = torch.stack([torch.ne(buf, other[k]).any()
                               for k, buf in st.buffers().items()])
        first.copy_(torch.where((first < 0) & differs, at, first))
        at.add_(1)

    calls = rdk.COUNTS["plain"]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up on a throwaway copy, as capture wants
        scratch = st.clone()
        for dedup in (False, True):
            rdk.rd_step_plain(scratch, dedup)
    torch.cuda.current_stream().wait_stream(side)
    del scratch
    graphs = {}
    for dedup in (False, True):
        graphs[dedup] = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graphs[dedup]):
            plain(dedup)
    rdk.COUNTS["plain"] = calls  # the warm-up's and the captures' calls ran nothing
    n = [0]

    def step(state, dedup):
        rdk.rd_step(state, dedup)
        graphs[dedup].replay()
        rdk.COUNTS["plain"] += 1
        n[0] += 1

    rd_torch.run_rd(st, step)
    for _ in range(past_exit):
        for dedup in (False, True):
            step(st, dedup)
    bad = {name: i for name, i in zip(names, first.tolist()) if i >= 0}
    if bad or int(at) != n[0]:
        name = min(bad, key=bad.get) if bad else None
        raise AssertionError(
            f"rd_step disagrees with its plain iteration: {name} after iteration "
            f"{bad.get(name)} (C={st.c_slots}, A={st.row_ids}, M={st.m_servers}); "
            f"first differing iteration by buffer: {bad}; {int(at)} of {n[0]} checked")
    return n[0]


def phase_rd_kernel(seed: int, jobs: list) -> int:
    """The RD step kernel against its plain iteration in lockstep: on the
    main path's first job (its state after every iteration) and on the
    edge cases; returns the largest difference, 0 (any other raises)."""
    t0 = time.perf_counter()
    first = min(jobs, key=lambda j: (j.arrival, j.job_id))
    cases = [("main path job 1", AssignmentProblem(
        busy=np.zeros(M_SERVERS, np.int64), mu=first.mu, groups=first.groups), None)]
    cases += [(name, *rd_edge_case(seed, name)) for name in RD_CASES]
    rows = []
    rdk.reset_counts()
    for label, problem, capacity in cases:
        t_case = time.perf_counter()
        st = rd_torch.initial_rd_state(problem, capacity=capacity)
        if st.route != "kernel":
            raise AssertionError(f"rd kernel case {label} does not take the kernel")
        n = rd_lockstep(st)
        rows.append({"case": label, "slots": st.c_slots, "row_ids": st.row_ids,
                     "servers": st.m_servers, "iterations": n,
                     "headroom": int(st.headroom), "seconds": time.perf_counter() - t_case})
    if rdk.COUNTS["rd_step"] != rdk.COUNTS["plain"] or rdk.COUNTS["wide"]:
        raise AssertionError(f"rd kernel lockstep counts {rdk.COUNTS}")
    if rows[RD_CASES.index("free-slot-shortage") + 1]["headroom"] >= 0:
        raise AssertionError("the free-slot-shortage case did not overflow")
    emit({
        "phase": "rd_kernel",
        "held": ["rd_step"],
        "tolerance": 0,
        "compared": "every buffer of the state after every iteration",
        "cases": rows,
        "launches": rdk.COUNTS["rd_step"],
        "max_abs_err": 0,
        "seconds": time.perf_counter() - t0,
    })
    return 0


def rd_wide_problem(seed: int, busy: np.ndarray) -> AssignmentProblem:
    """Five groups of 40-64 of the 4096 servers (past the reference
    kernel's 24 key rows, up to the step kernel's 64-id rows), 8-16 tasks
    each, which keeps the slot capacity at 4096 like the trace's jobs."""
    rng = np.random.default_rng(seed + 5)
    lo, hi = RD_WIDE_GROUPS
    groups = tuple(
        TaskGroup(int(rng.integers(8, 17)),
                  tuple(sorted(rng.choice(M_SERVERS, int(rng.integers(lo, hi + 1)),
                                          replace=False).tolist())))
        for _ in range(5)
    )
    return AssignmentProblem(busy=busy, mu=rng.integers(1, 6, M_SERVERS), groups=groups)


def _rd_launch_check(label: str, counts: dict, reruns: int) -> int:
    """The run's kernel launches, after checking that every iteration of
    every device RD run launched the kernel: no plain iteration, no wide
    row, no host re-run, launches equal to the loops' iterations."""
    launches = counts["rd_step"]
    iterations = sum(n for _, _, n in rd_torch.ITERATIONS)
    if launches == 0 or launches != iterations or counts["plain"] or counts["wide"] or reruns:
        raise AssertionError(
            f"rd main path ({label}) went around the kernel: {counts}, {iterations} "
            f"iterations, {reruns} host re-runs"
        )
    return launches


def phase_rd_main_path(seed: int, jobs: list) -> tuple[int, list]:
    """``rd_torch`` in the engine on the trace's first jobs, against the
    host ``rd``, then one problem with groups of 40-64 servers; returns
    the step kernel's launches and the bursts the chain admitted (their
    problems, as the engine handed them over)."""
    head = sorted(jobs, key=lambda j: (j.arrival, j.job_id))[:RD_JOBS]
    zeros = np.zeros(M_SERVERS, np.int64)
    capacities = [
        rd_torch.rd_slot_capacity(AssignmentProblem(busy=zeros, mu=j.mu, groups=j.groups))
        for j in head
    ]
    reduced = {
        "jobs": f"the first {RD_JOBS} of {N_JOBS} jobs: the whole trace needs "
        "~12M iterations, one launch and its host call each",
        "orderings": "no ocwf-acc: each rescan re-runs RD for every "
        "outstanding candidate",
    }
    per_arrival_cut = {
        "per_arrival_jobs": f"the first {RD_PER_ARRIVAL_JOBS} jobs (the first "
        "burst) again one arrival at a time, to drive the per-problem "
        "adapter within the time limit",
    }
    admitted: list[list] = []
    policy = make_policy("rd_torch")
    chain = policy.batch_assigner

    def recorded_chain(problems: list) -> list:
        admitted.append(problems)
        return chain(problems)

    policy = dataclasses.replace(policy, batch_assigner=recorded_chain)
    launches = 0
    for label, sub, batched in (
        ("chain", head, True),
        ("per_arrival", head[:RD_PER_ARRIVAL_JOBS], False),
    ):
        t_phase = time.perf_counter()
        torch.cuda.synchronize()
        rdk.reset_counts()
        rd_torch.reset_counts()
        wl.reset_counts()
        t0 = time.perf_counter()
        dev = SchedulingEngine(M_SERVERS, policy, batch_arrivals=batched).run(sub)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(rdk.COUNTS)
        reruns = rd_torch.COUNTS["host_reruns"]
        peaks = list(rd_torch.SLOT_PEAKS)
        t0 = time.perf_counter()
        host = SchedulingEngine(M_SERVERS, make_policy("rd")).run(sub)
        host_wall = time.perf_counter() - t0
        identical = (
            dev.jct == host.jct
            and dev.makespan == host.makespan
            and dev.failed_jobs == host.failed_jobs
        )
        steps = counts["rd_step"]
        emit({
            "phase": "rd_main_path",
            "seconds": time.perf_counter() - t_phase,
            "admission": label,
            "ordering": "fifo",
            "servers": M_SERVERS,
            "jobs": len(sub),
            "tasks": sum(j.n_tasks for j in sub),
            "bursts": len(bursts_of(sub)),
            "slot_capacities": capacities[: len(sub)],
            # (capacity, most slots live at once) per job the device solved
            "slot_peaks": peaks,
            "max_slot_fill": max(peak / c for c, peak in peaks) if peaks else None,
            "mean_jct": dev.mean_jct,
            "makespan": dev.makespan,
            "failed_jobs": len(dev.failed_jobs),
            "engine_wall_s": wall,
            "host_rd_wall_s": host_wall,
            "engine_over_host_rd": wall / host_wall,
            "launches": counts,
            "loop_iterations": sum(n for _, _, n in rd_torch.ITERATIONS),
            "host_reruns": reruns,
            "iterations_per_arrival": steps / len(sub),
            "host_wall_per_iteration_us": wall / steps * 1e6 if steps else None,
            "identical_to_host_rd": identical,
            "reduced": reduced if batched else {**reduced, **per_arrival_cut},
        })
        if not identical:
            raise AssertionError(f"rd_torch ({label}) schedule differs from host rd")
        if sorted(c for c, _ in peaks) != sorted(capacities[: len(sub)]):
            raise AssertionError(f"rd main path ({label}): slot peaks {peaks}")
        launches += _rd_launch_check(label, counts, reruns)

    # groups of 40-64 of the 4096 servers, against the host rd
    problem = rd_wide_problem(seed, np.random.default_rng(seed + 6).integers(0, 50, M_SERVERS))
    torch.cuda.synchronize()
    rdk.reset_counts()
    rd_torch.reset_counts()
    t0 = time.perf_counter()
    got = rd_torch.replica_deletion_torch(problem)
    wall = time.perf_counter() - t0
    counts, reruns = dict(rdk.COUNTS), rd_torch.COUNTS["host_reruns"]
    t0 = time.perf_counter()
    want = replica_deletion(problem)
    host_wall = time.perf_counter() - t0
    identical = got.alloc == want.alloc and got.phi == want.phi
    emit({
        "phase": "rd_main_path",
        "admission": "wide groups",
        "servers": M_SERVERS,
        "group_widths": sorted(len(g.servers) for g in problem.groups),
        "tasks": problem.n_tasks,
        "slots": rd_torch.ITERATIONS[0][0] if rd_torch.ITERATIONS else None,
        "row_ids": rd_torch.ITERATIONS[0][1] if rd_torch.ITERATIONS else None,
        "wall_s": wall,
        "host_rd_wall_s": host_wall,
        "launches": counts,
        "host_reruns": reruns,
        "identical_to_host_rd": identical,
    })
    if not identical:
        raise AssertionError("rd_torch differs from host rd on the wide-group problem")
    launches += _rd_launch_check("wide groups", counts, reruns)
    return launches, admitted


# ---- the control plane on the main path's trace -------------------------------


def _same_schedule(a, b) -> bool:
    return (a.jct == b.jct and a.makespan == b.makespan
            and a.failed_jobs == b.failed_jobs and a.reassignments == b.reassignments)


# every result field the online mechanisms move
ONLINE_FIELDS = ("jct", "makespan", "failed_jobs", "shed_jobs", "reassignments", "steals",
                 "speculations", "spec_cancels", "retries", "deferred_peak")


def _wf_fused_check(label: str, counts: dict, calls: int) -> int:
    """The fused launches of a ``wf_torch`` run, after checking one launch
    per adapter call, no K1/K2 launch and no plain call."""
    n_fused = _fused_launches(counts)
    if (n_fused == 0 or n_fused != calls or counts["plain"]
            or counts["waterlevel"] or counts["waterlevel_batch"]):
        raise AssertionError(f"{label}: {n_fused} fused launches for {calls} adapter "
                             f"calls, counts {counts}")
    return n_fused


def _reset_launches() -> None:
    torch.cuda.synchronize()
    wl.reset_counts()
    rdk.reset_counts()
    rd_torch.reset_counts()
    wf_torch.CALLS["adapter"] = 0


def phase_control_plane(jobs: list, slot_runs: dict) -> dict:
    """``SchedulingEngine(..., step_mode="event")`` with ``wf_torch`` on the
    whole trace, against the slot loop's run (main path) and the host
    ``wf`` plane; then ``ControlPlane(rd_torch, setf)`` on the first
    ``RD_JOBS`` jobs against the host ``rd`` plane.  Records every
    ``wf_torch`` call's problems for the exact phase."""
    policy = make_policy("wf_torch")
    calls: list[tuple[list, list]] = []  # (problems, assignments) per adapter call

    def one(problem):
        out = policy.assigner(problem)
        calls.append(([problem], [out]))
        return out

    def chain(problems):
        out = policy.batch_assigner(problems)
        calls.append((problems, out))
        return out

    _reset_launches()
    t0 = time.perf_counter()
    dev = SchedulingEngine(
        M_SERVERS, dataclasses.replace(policy, assigner=one, batch_assigner=chain),
        step_mode="event",
    ).run(jobs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, n_calls = dict(wl.COUNTS), wf_torch.CALLS["adapter"]
    t0 = time.perf_counter()
    host = SchedulingEngine(M_SERVERS, make_policy("wf"), step_mode="event").run(jobs)
    host_wall = time.perf_counter() - t0
    slot, slot_wall = slot_runs["fifo"]
    emit({
        "phase": "control_plane",
        "policy": "wf_torch",
        "ordering": "fifo",
        "servers": M_SERVERS,
        "jobs": len(jobs),
        "mean_jct": dev.mean_jct,
        "p99_jct": dev.jct_percentile(99),
        "makespan": dev.makespan,
        "failed_jobs": len(dev.failed_jobs),
        "heap_peak": dev.heap_peak,
        "event_loop_wall_s": wall,
        "slot_loop_wall_s": slot_wall,
        "event_over_slot": wall / slot_wall,
        "host_wf_plane_wall_s": host_wall,
        "launches": counts,
        "adapter_calls": n_calls,
        "identical_to_slot_loop": _same_schedule(dev, slot),
        "identical_to_host_wf_plane": _same_schedule(dev, host),
    })
    if not (_same_schedule(dev, slot) and _same_schedule(dev, host)):
        raise AssertionError("the wf_torch event loop differs from the slot loop or host wf")
    n_fused = _wf_fused_check("control_plane", counts, n_calls)

    head = sorted(jobs, key=lambda j: (j.arrival, j.job_id))[:RD_JOBS]
    _reset_launches()
    t0 = time.perf_counter()
    plane = ControlPlane(M_SERVERS, policy="rd_torch", ordering="setf")
    plane.submit_many(head)
    rd_dev = plane.drain()
    torch.cuda.synchronize()
    rd_wall = time.perf_counter() - t0
    rd_counts, reruns = dict(rdk.COUNTS), rd_torch.COUNTS["host_reruns"]
    runs = len(rd_torch.ITERATIONS)
    t0 = time.perf_counter()
    host_plane = ControlPlane(M_SERVERS, policy="rd", ordering="setf")
    host_plane.submit_many(head)
    rd_host = host_plane.drain()
    rd_host_wall = time.perf_counter() - t0
    emit({
        "phase": "control_plane",
        "policy": "rd_torch",
        "ordering": "setf",
        "servers": M_SERVERS,
        "jobs": len(head),
        "mean_jct": rd_dev.mean_jct,
        "makespan": rd_dev.makespan,
        "device_rd_runs": runs,
        "plane_wall_s": rd_wall,
        "host_rd_plane_wall_s": rd_host_wall,
        "launches": rd_counts,
        "loop_iterations": sum(n for _, _, n in rd_torch.ITERATIONS),
        "host_reruns": reruns,
        "identical_to_host_rd_plane": _same_schedule(rd_dev, rd_host),
        "reduced": {"jobs": f"the first {RD_JOBS} of {N_JOBS} jobs, as the RD main path"},
    })
    if not _same_schedule(rd_dev, rd_host):
        raise AssertionError("ControlPlane(rd_torch, setf) differs from the host rd plane")
    rd_launches = _rd_launch_check("control plane setf", rd_counts, reruns)
    return {"launches": {"wf_fused": n_fused, "rd_step": rd_launches},
            "calls": calls, "wf_torch": dev, "event_wall_s": wall}


def _straggler_timeline(seed: int, horizon: int) -> tuple:
    """``STRAGGLERS`` random servers slowed ``STRAGGLER_FACTOR``-fold every
    ``STRAGGLER_EVERY`` slots, each for ``STRAGGLER_EVERY`` slots."""
    rng = np.random.default_rng(seed + 40)
    events = []
    for slot in range(STRAGGLER_EVERY // 2, horizon, STRAGGLER_EVERY):
        for m in sorted(rng.choice(M_SERVERS, STRAGGLERS, replace=False).tolist()):
            events.append(ServerEvent(slot, "slowdown", m, factor=STRAGGLER_FACTOR))
            events.append(ServerEvent(slot + STRAGGLER_EVERY, "speedup", m))
    return tuple(events)


def phase_faults_online(seed: int, jobs: list) -> dict:
    """The first ``ONLINE_JOBS`` jobs replayed below saturation, through
    the plane with ``wf_torch`` and with the host ``wf``, under one
    timeline each: a rack failure with retry, a rotating straggler with
    stealing and speculation (and without, for the mean JCT it buys), and
    a point past saturation with admission control.  Every JCT, failed and
    shed set and counter identical; one fused launch per adapter call."""
    head = sorted(jobs, key=lambda j: (j.arrival, j.job_id))[:ONLINE_JOBS]
    qps = ONLINE_RHO * saturation_qps(head, M_SERVERS)
    replayed = replay_client(head, qps=qps)
    rack = rack_failure_timeline(RACK_SERVERS, fail_at=RACK_FAIL_AT,
                                 recover_at=RACK_RECOVER_AT)
    horizon = SchedulingEngine(M_SERVERS, make_policy("wf"),
                               step_mode="event").run(replayed).makespan
    straggle = _straggler_timeline(seed, horizon)
    overloaded = overload_client(head, rho=ONLINE_OVERLOAD_RHO, n_servers=M_SERVERS)
    drills = (
        ("rack_retry", replayed, dict(events=rack, resilience=ResilienceConfig(retry=True))),
        ("straggler_plain", replayed, dict(events=straggle)),
        ("straggler_steal_spec", replayed, dict(events=straggle, stealing=True,
                                                 speculation=True)),
        ("overload_admission", overloaded, dict(resilience=ResilienceConfig(admission=True))),
    )
    fused = 0
    rows = {}
    for label, trace, kw in drills:
        _reset_launches()
        t0 = time.perf_counter()
        dev = SchedulingEngine(M_SERVERS, make_policy("wf_torch"), step_mode="event",
                               **kw).run(trace)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts, n_calls = dict(wl.COUNTS), wf_torch.CALLS["adapter"]
        t0 = time.perf_counter()
        host = SchedulingEngine(M_SERVERS, make_policy("wf"), step_mode="event",
                                **kw).run(trace)
        host_wall = time.perf_counter() - t0
        differs = [f for f in ONLINE_FIELDS if getattr(dev, f) != getattr(host, f)]
        rows[label] = dev
        emit({
            "phase": "faults_online",
            "drill": label,
            "servers": M_SERVERS,
            "jobs": len(trace),
            "qps": qps if trace is replayed else None,
            "rho": ONLINE_RHO if trace is replayed else ONLINE_OVERLOAD_RHO,
            "events": len(kw.get("events", ())),
            "mean_jct": dev.mean_jct,
            "p99_jct": dev.jct_percentile(99),
            "makespan": dev.makespan,
            "failed_jobs": len(dev.failed_jobs),
            "shed_jobs": dev.n_shed,
            "deferred_peak": dev.deferred_peak,
            "reassignments": dev.reassignments,
            "retries": dev.retries,
            "steals": dev.steals,
            "speculations": dev.speculations,
            "spec_cancels": dev.spec_cancels,
            "heap_peak": dev.heap_peak,
            "plane_wall_s": wall,
            "host_wf_plane_wall_s": host_wall,
            "launches": counts,
            "adapter_calls": n_calls,
            "identical_to_host_wf_plane": not differs,
            "reduced": {"jobs": f"the first {ONLINE_JOBS} of {N_JOBS} jobs, re-timed"},
        })
        if differs:
            raise AssertionError(f"faults_online {label}: wf_torch differs from host wf "
                                 f"in {differs}")
        fused += _wf_fused_check(f"faults_online {label}", counts, n_calls)
    exercised = {
        "rack_retry": rows["rack_retry"].retries > 0 and rows["rack_retry"].reassignments > 0,
        "straggler_steal_spec": rows["straggler_steal_spec"].steals > 0
        and rows["straggler_steal_spec"].speculations > 0,
        "overload_admission": rows["overload_admission"].deferred_peak > 0,
    }
    plain, online = rows["straggler_plain"], rows["straggler_steal_spec"]
    emit({
        "phase": "faults_online",
        "drill": "summary",
        "steal_spec_mean_jct": online.mean_jct,
        "plain_mean_jct": plain.mean_jct,
        "steal_spec_over_plain": online.mean_jct / plain.mean_jct,
        "steal_spec_p99_jct": online.jct_percentile(99),
        "plain_p99_jct": plain.jct_percentile(99),
        "mechanisms_exercised": exercised,
    })
    if not all(exercised.values()):
        raise AssertionError(f"faults_online: a drill did not reach its mechanism: {exercised}")
    return {"launches": {"wf_fused": fused, "rd_step": 0}}


def _arrival_problems(calls: list, n: int) -> list[tuple]:
    """The first ``n`` (problem, wf_torch assignment) pairs of the recorded
    calls, each problem with the busy vector its arrival saw (a chained
    burst's problems carry the pre-burst vector: commit eq. 2 between)."""
    out = []
    for problems, assignments in calls:
        busy = problems[0].busy
        for problem, assignment in zip(problems, assignments):
            problem = dataclasses.replace(problem, busy=busy)
            out.append((problem, assignment))
            if len(out) == n:
                return out
            busy = commit_busy(busy, assignment, problem.mu, problem.n_servers)
    return out


def exact_host(problem: AssignmentProblem) -> dict:
    """OBTA, NLIP (each with its wall seconds) and the host ``rd`` on one
    problem: the host side of :func:`phase_exact`, run in the host worker."""
    t0 = time.perf_counter()
    opt = obta(problem)
    t1 = time.perf_counter()
    base = nlip(problem)
    t2 = time.perf_counter()
    host_rd = replica_deletion(problem)
    return {"obta": opt.phi, "obta_s": t1 - t0, "nlip": base.phi, "nlip_s": t2 - t1,
            "rd": host_rd.phi, "rd_alloc": host_rd.alloc}


def phase_exact(jobs: list, plane: dict, pool) -> dict:
    """OBTA and NLIP (host) on the first ``EXACT_PROBLEMS`` arrival problems
    of the ``wf_torch`` fifo plane: Φ_obta = Φ_nlip ≤ Φ(wf_torch) ≤ K_c ·
    Φ_obta on each, and Φ_obta ≤ Φ(rd_plus) ≤ Φ(rd_torch), with
    ``rd_torch``'s allocation equal to the host ``rd``'s.  The host side
    (:func:`exact_host`, its solver times too) runs in the host worker
    ``pool`` while ``rd_torch`` runs on the card.  Then the plane with
    ``obta`` on the whole trace, and ``rd_plus`` / ``obta`` / ``wf_torch``
    on the first ``RD_PLUS_JOBS`` jobs: mean and p99 JCT each."""
    pairs = _arrival_problems(plane["calls"], EXACT_PROBLEMS)
    host = pool.map_async(exact_host, [problem for problem, _ in pairs])
    obta_s, nlip_s, rows = [], [], []
    _reset_launches()
    device = []
    for problem, _ in pairs:
        rd_a = rd_torch.replica_deletion_torch(problem)
        # rd_plus is the 1-opt polish of rd_torch's result
        # (replica_deletion_plus): polish the device RD just run rather
        # than run it again; the plane below drives rd_plus itself
        device.append((rd_a, rebalance_1opt(problem, rd_a).phi))
    for i, ((problem, wf_a), (rd_a, rd_plus), h) in enumerate(zip(pairs, device, host.get())):
        obta_s.append(h["obta_s"])
        nlip_s.append(h["nlip_s"])
        k_c = len(problem.groups)
        row = {"k_c": k_c, "obta": h["obta"], "nlip": h["nlip"], "wf_torch": wf_a.phi,
               "wf_torch_realized": wf_a.realized_phi(problem), "rd_torch": rd_a.phi,
               "rd": h["rd"], "rd_plus": rd_plus}
        rows.append(row)
        opt_phi = h["obta"]
        if not (opt_phi == h["nlip"] and opt_phi <= wf_a.phi <= k_c * opt_phi):
            raise AssertionError(f"exact: problem {i} breaks Φ_obta = Φ_nlip ≤ Φ_wf ≤ "
                                 f"K_c·Φ_obta: {row}")
        if rd_a.alloc != h["rd_alloc"] or rd_a.phi != h["rd"]:
            raise AssertionError(f"exact: problem {i}: rd_torch differs from host rd: {row}")
        if not (opt_phi <= row["rd_plus"] <= row["rd_torch"]):
            raise AssertionError(f"exact: problem {i} breaks Φ_obta ≤ Φ_rd_plus ≤ "
                                 f"Φ_rd_torch: {row}")
    torch.cuda.synchronize()
    rd_counts, reruns = dict(rdk.COUNTS), rd_torch.COUNTS["host_reruns"]
    rd_launches = _rd_launch_check("exact", rd_counts, reruns)
    ratios = [r["wf_torch"] / r["obta"] for r in rows]
    emit({
        "phase": "exact",
        "problems": len(rows),
        "k_c": [min(r["k_c"] for r in rows), max(r["k_c"] for r in rows)],
        "obta_equals_nlip": True,
        "obta_ms_per_problem": float(np.mean(obta_s)) * 1e3,
        "nlip_ms_per_problem": float(np.mean(nlip_s)) * 1e3,
        "nlip_over_obta": float(np.sum(nlip_s) / np.sum(obta_s)),
        "wf_over_obta_max": max(ratios),
        "wf_over_obta_mean": float(np.mean(ratios)),
        "wf_at_optimum": sum(r["wf_torch"] == r["obta"] for r in rows),
        "wf_realized_over_obta_max": max(r["wf_torch_realized"] / r["obta"] for r in rows),
        "rd_torch_over_obta_max": max(r["rd_torch"] / r["obta"] for r in rows),
        "rd_plus_over_obta_max": max(r["rd_plus"] / r["obta"] for r in rows),
        "rd_plus_improved": sum(r["rd_plus"] < r["rd_torch"] for r in rows),
        "rd_launches": rd_counts,
        "host_reruns": reruns,
    })

    order = sorted(jobs, key=lambda j: (j.arrival, j.job_id))
    head = order[:RD_PLUS_JOBS]
    results, walls = {}, {}
    fused = 0
    for label, policy, trace in (
        ("obta whole trace", "obta", jobs),
        ("obta", "obta", head),
        ("wf_torch", "wf_torch", head),
        ("rd_plus", "rd_plus", head),
    ):
        _reset_launches()
        t0 = time.perf_counter()
        results[label] = SchedulingEngine(M_SERVERS, make_policy(policy),
                                          step_mode="event").run(trace)
        torch.cuda.synchronize()
        walls[label] = time.perf_counter() - t0
        if policy == "wf_torch":
            fused += _wf_fused_check("exact wf_torch", dict(wl.COUNTS),
                                     wf_torch.CALLS["adapter"])
        if policy == "rd_plus":
            rd_plus_launches = _rd_launch_check("exact rd_plus", dict(rdk.COUNTS),
                                                rd_torch.COUNTS["host_reruns"])
            rd_launches += rd_plus_launches
    whole = {"obta": results["obta whole trace"], "wf_torch": plane["wf_torch"]}
    emit({
        "phase": "exact",
        "plane": "whole trace",
        "jobs": len(jobs),
        "jct": {name: {"mean": r.mean_jct, "p99": r.jct_percentile(99),
                       "makespan": r.makespan} for name, r in whole.items()},
        "obta_plane_wall_s": walls["obta whole trace"],
        "wf_torch_plane_wall_s": plane["event_wall_s"],
    })
    emit({
        "phase": "exact",
        "plane": f"first {RD_PLUS_JOBS} jobs",
        "jobs": len(head),
        "jct": {name: {"mean": results[name].mean_jct, "p99": results[name].jct_percentile(99),
                       "makespan": results[name].makespan}
                for name in ("obta", "wf_torch", "rd_plus")},
        "plane_wall_s": {name: walls[name] for name in ("obta", "wf_torch", "rd_plus")},
        "rd_plus_launches": rd_plus_launches,
        "reduced": {"jobs": f"rd_plus on the first {RD_PLUS_JOBS} of {N_JOBS} jobs: one "
                    f"device RD per arrival, {rd_plus_launches // len(head)} K3 launches "
                    "each"},
    })
    return {"launches": {"wf_fused": fused, "rd_step": rd_launches}}


def _plane_serve_requests(cfg, seed: int) -> list:
    rng = np.random.default_rng(seed + 31)
    lo, hi = SSM_PROMPT
    return [
        Request(i, rng.integers(1, cfg.vocab, int(rng.integers(lo, hi + 1))
                                ).astype(np.int32), max_new_tokens=SSM_NEW)
        for i in range(SSM_REQUESTS)
    ]


def _pool(params, cfg) -> RoutedServePool:
    engines = {
        i: ServeEngine(params, cfg, batch_slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN,
                       eos_token=-1)
        for i in range(SERVE_REPLICAS)
    }
    return RoutedServePool(engines, ReplicaRouter(SERVE_REPLICAS, policy="wf_torch"))


def phase_plane_serve(seed: int, jobs: list) -> dict:
    """Two Mamba2-130M replicas at full width behind a ``wf_torch`` router
    serve the SSM traffic through ``ControlPlane.submit_request``, one
    request a slot, while the plane schedules the trace's first
    ``PLANE_SERVE_JOBS`` jobs with ``wf_torch``; the tokens equal those of
    the same pool driven alone on the same cadence (a request joins at
    its slot, the pool steps once a slot from the first request's next
    slot)."""
    cfg = get_config(PLANE_SERVE_ARCH)
    params = init_params(torch.Generator(device="cuda").manual_seed(seed), cfg)
    head = sorted(jobs, key=lambda j: (j.arrival, j.job_id))[:PLANE_SERVE_JOBS]
    t_first = head[PLANE_SERVE_FIRST].arrival

    alone = _pool(params, cfg)
    reqs = _plane_serve_requests(cfg, seed)
    t0 = time.perf_counter()
    for i, req in enumerate(reqs):  # request i joins at slot i, then the slot's step
        if i and not alone.busy():  # the plane's heartbeats would have paused
            raise AssertionError("plane_serve: the pool idled between requests")
        alone.submit(req)
        if i:
            alone.step()
    while alone.busy():
        alone.step()
    torch.cuda.synchronize()
    alone_wall = time.perf_counter() - t0
    want = {r.request_id: list(r.generated) for r in reqs}

    pool = _pool(params, cfg)
    plane_reqs = _plane_serve_requests(cfg, seed)
    _reset_launches()
    _reset_model_counts()
    wf_torch.CALLS["adapter"] = 0
    t0 = time.perf_counter()
    plane = ControlPlane(M_SERVERS, policy="wf_torch", serve_pool=pool)
    plane.submit_many(head)
    for i, req in enumerate(plane_reqs):
        plane.submit_request(at=t_first + i, request=req)
    res = plane.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, n_calls = _model_counts(), wf_torch.CALLS["adapter"]
    got = {r.request_id: list(r.generated) for r in plane_reqs}
    emit({
        "phase": "plane_serve",
        "arch": PLANE_SERVE_ARCH,
        "layers": cfg.n_layers,
        "replicas": SERVE_REPLICAS,
        "requests": len(plane_reqs),
        "jobs": len(head),
        "first_request_slot": t_first,
        "finished": len(res.serve_latency),
        "inflight": res.inflight_requests,
        "serve_latency_slots": res.serve_latency,
        "mean_jct": res.mean_jct,
        "plane_wall_s": wall,
        "pool_alone_wall_s": alone_wall,
        "launches": counts,
        "adapter_calls": n_calls,
        "tokens_equal_pool_alone": got == want,
        "reduced": {"traffic": f"{SSM_REQUESTS} requests, prompts {SSM_PROMPT[0]}-"
                    f"{SSM_PROMPT[1]} tokens, {SSM_NEW} new each; the first "
                    f"{PLANE_SERVE_JOBS} jobs"},
    })
    if got != want or len(res.serve_latency) != len(plane_reqs) or res.inflight_requests:
        raise AssertionError("plane_serve: the plane-driven pool's tokens differ from the "
                             "pool's alone, or a request did not finish")
    if any(len(t) != SSM_NEW for t in got.values()):
        raise AssertionError("plane_serve: a request did not get its tokens")
    if any(c["plain"] for c in counts.values()) or counts["rmsnorm"]["rmsnorm"] == 0:
        raise AssertionError(f"plane_serve went around the kernels: {counts}")
    fused = _wf_fused_check("plane_serve", counts["waterlevel"], n_calls)
    del params, pool, alone
    torch.cuda.empty_cache()
    return {"launches": {"wf_fused": fused, "rd_step": 0}, "counts": counts}


# ---- observability, the CSV replay, MoE routing and the contracts ------------


def _hist_total(m, name: str) -> tuple[int, int]:
    """(samples, summed µs) of one profiler histogram."""
    h = m.histogram(name)
    return (h.count, h.total) if h is not None else (0, 0)


def _device_split(m) -> dict:
    """Per dispatch kind: calls, first launches of a variant ("compile")
    and the later ones, with their summed walls."""
    kinds = sorted({k.split(".")[1] for k in m.counters if k.startswith("device.")})
    out = {}
    for kind in kinds:
        n_c, us_c = _hist_total(m, f"device.{kind}.compile_us")
        n_e, us_e = _hist_total(m, f"device.{kind}.exec_us")
        out[kind] = {"calls": m.counter(f"device.{kind}.calls"),
                     "first_launches": n_c, "first_launch_ms": us_c / 1e3,
                     "later_launches": n_e, "later_ms": us_e / 1e3,
                     "host_fallback": m.counter(f"device.{kind}.host_fallback")}
    return out


def phase_observed_main_path(jobs: list, slot_runs: dict) -> dict:
    """The 4096-server fifo WF main path again under ``observe()``: the
    schedule equals the unobserved run's, and the profiler's calls equal
    the adapter calls and the fused launches; the trace's size, the two
    walls and the first-launch / later-launch split.  Then
    ``ControlPlane(rd_torch, setf)`` on the first jobs under a session
    against the host ``rd`` plane, ``device.rd-device.calls`` equal to
    the device RD runs; the Chrome export round-trips."""
    unobserved, unobserved_wall = slot_runs["fifo"]
    _reset_launches()
    t0 = time.perf_counter()
    with obs.observe(trace_capacity=OBSERVED_TRACE_CAPACITY) as session:
        dev = SchedulingEngine(M_SERVERS, make_policy("wf_torch", "fifo")).run(jobs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, n_calls = dict(wl.COUNTS), wf_torch.CALLS["adapter"]
    m = session.metrics
    split = _device_split(m)
    profiled = {k: m.counter(f"device.{k}.calls") for k in ("wf-groups", "wf-chain")}
    identical = (_same_schedule(dev, unobserved)
                 and len(dev.overhead_s) == len(unobserved.overhead_s))
    emit({
        "phase": "observed_main_path",
        "policy": "wf_torch",
        "ordering": "fifo",
        "servers": M_SERVERS,
        "jobs": len(jobs),
        "trace_total": session.trace.total,
        "trace_dropped": session.trace.dropped,
        "snapshots": m.n_snapshots,
        "observed_wall_s": wall,
        "unobserved_wall_s": unobserved_wall,
        "observed_over_unobserved": wall / unobserved_wall,
        "device": split,
        "launches": counts,
        "adapter_calls": n_calls,
        "identical_to_unobserved": identical,
    })
    if not identical:
        raise AssertionError("observed_main_path: the observed schedule differs")
    n_fused = _wf_fused_check("observed_main_path", counts, n_calls)
    if (profiled["wf-groups"] != counts["wf_groups"] or profiled["wf-chain"] != counts["wf_chain"]
            or sum(profiled.values()) != n_calls or session.trace.dropped):
        raise AssertionError(f"observed_main_path: profiled {profiled}, launches {counts}, "
                             f"{n_calls} adapter calls, {session.trace.dropped} dropped")

    head = sorted(jobs, key=lambda j: (j.arrival, j.job_id))[:OBSERVED_RD_JOBS]
    _reset_launches()
    t0 = time.perf_counter()
    with obs.observe() as rd_session:
        plane = ControlPlane(M_SERVERS, policy="rd_torch", ordering="setf")
        plane.submit_many(head)
        rd_dev = plane.drain()
    torch.cuda.synchronize()
    rd_wall = time.perf_counter() - t0
    rd_counts, reruns = dict(rdk.COUNTS), rd_torch.COUNTS["host_reruns"]
    runs = len(rd_torch.ITERATIONS)
    host_plane = ControlPlane(M_SERVERS, policy="rd", ordering="setf")
    host_plane.submit_many(head)
    rd_host = host_plane.drain()
    rd_split = _device_split(rd_session.metrics)
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "observed_main_path.trace.json"
        path.write_text(json.dumps(session.trace.to_chrome_trace()))
        trace_mb = path.stat().st_size / 1e6
        records, strings = parse_chrome_trace(json.loads(path.read_text()))
    round_trip = records == session.trace.records() and tuple(strings) == session.trace.strings
    emit({
        "phase": "observed_main_path",
        "policy": "rd_torch",
        "ordering": "setf",
        "servers": M_SERVERS,
        "jobs": len(head),
        "plane_wall_s": rd_wall,
        "device_rd_runs": runs,
        "device": rd_split,
        "launches": rd_counts,
        "loop_iterations": sum(n for _, _, n in rd_torch.ITERATIONS),
        "identical_to_host_rd_plane": _same_schedule(rd_dev, rd_host),
        "chrome_trace_mb": trace_mb,
        "chrome_round_trip": round_trip,
        "reduced": {"jobs": f"the first {OBSERVED_RD_JOBS} of {N_JOBS} jobs"},
    })
    if not _same_schedule(rd_dev, rd_host):
        raise AssertionError("observed_main_path: ControlPlane(rd_torch, setf) differs from rd")
    rd_launches = _rd_launch_check("observed setf", rd_counts, reruns)
    if rd_session.metrics.counter("device.rd-device.calls") != runs or not round_trip:
        raise AssertionError(f"observed_main_path: rd-device calls {rd_split} for {runs} "
                             f"device RD runs, Chrome round trip {round_trip}")
    return {"launches": {"wf_fused": n_fused, "rd_step": rd_launches},
            "wall_s": wall, "unobserved_wall_s": unobserved_wall}


def write_batch_task_csv(path: Path, seed: int) -> dict:
    """A headerless ``batch_task.csv`` in the published 8-column schema,
    drawn from ``seed``: CSV_JOBS jobs whose Terminated rows hold
    CSV_TASKS instances in all, CSV_GROUPS task groups a job, and about
    CSV_OFF_STATUS of the rows in other statuses (which the replay skips);
    the rows shuffled.  Data made from a seed in the trace's schema at the
    paper's segment size, not the trace's statistics."""
    rng = np.random.default_rng(seed + 50)
    groups = rng.integers(CSV_GROUPS[0], CSV_GROUPS[1] + 1, CSV_JOBS)
    raw = rng.lognormal(0.0, 1.0, CSV_JOBS)
    sizes = np.maximum(groups, np.floor(raw / raw.sum() * CSV_TASKS).astype(np.int64))
    sizes[np.argmax(sizes)] += CSV_TASKS - int(sizes.sum())
    create = 86_400 + np.cumsum(rng.exponential(12.0, CSV_JOBS)).astype(np.int64)
    rows, off = [], 0
    for j in range(CSV_JOBS):
        cuts = np.sort(rng.choice(np.arange(1, sizes[j]), groups[j] - 1, replace=False))
        for k, n in enumerate(np.diff(np.concatenate([[0], cuts, [sizes[j]]]))):
            t = int(create[j]) + 3 * k
            cpu, mem = int(rng.choice((50, 100, 200))), float(rng.choice((0.25, 0.5)))
            rows.append(f"{t},{t + 600},j_{j:05d},task_{k},{n},Terminated,{cpu},{mem}")
            if rng.random() < CSV_OFF_STATUS:
                status = str(rng.choice(("Failed", "Waiting", "Running", "Cancelled")))
                rows.append(f"{t + 1},{t + 900},j_{j:05d},task_{k}_r,"
                            f"{int(rng.integers(1, 500))},{status},{cpu},{mem}")
                off += 1
    path.write_text("\n".join(rows[i] for i in rng.permutation(len(rows))) + "\n")
    return {"rows": len(rows), "rows_not_terminated": off, "bytes": path.stat().st_size}


def _jobs_key(jobs: list) -> list:
    return [(j.job_id, j.arrival, [(g.size, g.servers) for g in j.groups], j.mu.tolist())
            for j in jobs]


def phase_csv_replay(seed: int) -> dict:
    """The seeded CSV replayed through ``generate("cluster_v2017",
    path=...)`` in 4096-row chunks at 1,300 servers: the two-pass replay
    equals a replay in 97-row chunks and the group sizes and arrival order
    of a one-shot ``load_batch_task_csv``; ``wf_torch`` fifo over every job
    and ``rd_torch`` over the first jobs, each against the host policy."""
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "batch_task.csv"
        shape = write_batch_task_csv(path, seed)
        kw = dict(path=str(path), n_servers=CSV_SERVERS, seed=seed)
        t0 = time.perf_counter()
        jobs = generate("cluster_v2017", chunk_rows=CSV_CHUNK_ROWS, **kw)
        replay_s = time.perf_counter() - t0
        small = generate("cluster_v2017", chunk_rows=CSV_SMALL_CHUNK, **kw)
        rows = load_batch_task_csv(str(path))
    first: dict[str, int] = {}
    for r in rows:
        first[r.job_id] = min(first.get(r.job_id, r.create_timestamp), r.create_timestamp)
    order = sorted(first, key=lambda j: (first[j], j))
    one_shot = [[r.instance_num for r in sorted(
        (r for r in rows if r.job_id == j), key=lambda r: (r.create_timestamp, r.task_id))]
        for j in order]
    chunked_equal = _jobs_key(jobs) == _jobs_key(small)
    one_shot_equal = [[g.size for g in j.groups] for j in jobs] == one_shot
    if not (chunked_equal and one_shot_equal and len(jobs) == CSV_JOBS
            and sum(j.n_tasks for j in jobs) == CSV_TASKS):
        raise AssertionError(f"csv_replay: {len(jobs)} jobs, chunked equal {chunked_equal}, "
                             f"one-shot equal {one_shot_equal}")

    _reset_launches()
    t0 = time.perf_counter()
    dev = SchedulingEngine(CSV_SERVERS, make_policy("wf_torch")).run(jobs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, n_calls = dict(wl.COUNTS), wf_torch.CALLS["adapter"]
    t0 = time.perf_counter()
    host = SchedulingEngine(CSV_SERVERS, make_policy("wf")).run(jobs)
    host_wall = time.perf_counter() - t0
    identical = _same_schedule(dev, host)
    n_fused = _wf_fused_check("csv_replay", counts, n_calls)

    head = jobs[:CSV_RD_JOBS]
    _reset_launches()
    t0 = time.perf_counter()
    rd_dev = SchedulingEngine(CSV_SERVERS, make_policy("rd_torch")).run(head)
    torch.cuda.synchronize()
    rd_wall = time.perf_counter() - t0
    rd_counts, reruns = dict(rdk.COUNTS), rd_torch.COUNTS["host_reruns"]
    iterations = sum(n for _, _, n in rd_torch.ITERATIONS)
    t0 = time.perf_counter()
    rd_host = SchedulingEngine(CSV_SERVERS, make_policy("rd")).run(head)
    rd_host_wall = time.perf_counter() - t0
    emit({
        "phase": "csv_replay",
        "csv": {**shape, "schema": "cluster-trace-v2017 batch_task.csv, 8 columns, "
                "headerless", "source": f"drawn from --seed {seed}, not the trace"},
        "servers": CSV_SERVERS,
        "jobs": len(jobs),
        "tasks": sum(j.n_tasks for j in jobs),
        "groups": sum(len(j.groups) for j in jobs),
        "chunk_rows": CSV_CHUNK_ROWS,
        "replay_s": replay_s,
        "equal_to_small_chunks": chunked_equal,
        "equal_to_one_shot_load": one_shot_equal,
        "wf_torch": {"mean_jct": dev.mean_jct, "makespan": dev.makespan, "wall_s": wall,
                     "host_wf_wall_s": host_wall, "identical_to_host_wf": identical,
                     "launches": counts, "adapter_calls": n_calls},
        "rd_torch": {"jobs": len(head), "tasks": sum(j.n_tasks for j in head),
                     "mean_jct": rd_dev.mean_jct, "wall_s": rd_wall,
                     "host_rd_wall_s": rd_host_wall, "launches": rd_counts,
                     "loop_iterations": iterations,
                     "identical_to_host_rd": _same_schedule(rd_dev, rd_host)},
    })
    if not identical or not _same_schedule(rd_dev, rd_host):
        raise AssertionError("csv_replay: a device schedule differs from the host policy's")
    rd_launches = _rd_launch_check("csv replay", rd_counts, reruns)
    return {"launches": {"wf_fused": n_fused, "rd_step": rd_launches}}


def phase_moe_balance(seed: int) -> dict:
    """DeepSeek-V3's routed experts on its 32-GPU prefill unit: each step
    one ``balance_expert_replicas`` call on the card (one fused launch)
    against the same call on the CPU tensors (the plain loop), alloc and
    Φ equal; tokens conserved; Φ at most the static first-replica split's;
    the queue carried between steps."""
    gen = torch.Generator().manual_seed(seed)
    placement = replica_placement(MOE_EXPERTS, MOE_DEVICES, MOE_REPLICAS, generator=gen)
    first = placement[:, 0].numpy()
    rng = np.random.default_rng(seed + 60)
    weights = 1.0 / np.arange(1, MOE_EXPERTS + 1) ** MOE_ZIPF
    slots = MOE_TOKENS * MOE_TOP_K
    drain = slots // MOE_DEVICES
    rate = torch.ones(MOE_DEVICES, dtype=torch.int32)
    rate_dev, placement_dev = rate.cuda(), placement.cuda()
    queue = np.zeros(MOE_DEVICES, np.int64)
    _reset_launches()
    card_s, plain_s, phis, static_phis = [], [], [], []
    for _ in range(MOE_STEPS):
        load = rng.multinomial(slots, rng.permutation(weights / weights.sum()))
        load_t = torch.from_numpy(load.astype(np.int32))
        queue_t = torch.from_numpy(queue.astype(np.int32))
        launched = wl.COUNTS["wf_groups"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        alloc, phi = balance_expert_replicas(load_t.cuda(), placement_dev, queue_t.cuda(),
                                             rate_dev)
        alloc, phi = alloc.cpu(), int(phi)
        card_s.append(time.perf_counter() - t0)
        if wl.COUNTS["wf_groups"] != launched + 1:
            raise AssertionError("moe_balance: a call took other than one fused launch")
        t0 = time.perf_counter()
        want_alloc, want_phi = balance_expert_replicas(load_t, placement, queue_t, rate)
        plain_s.append(time.perf_counter() - t0)
        static = queue.copy()
        np.add.at(static, first, load)
        a = alloc.numpy()
        if (not torch.equal(alloc, want_alloc) or phi != int(want_phi)
                or a.sum() != slots or (a.sum(axis=1) != load).any()
                or phi > int(static.max())):
            raise AssertionError("moe_balance: card differs from plain, tokens lost, or Φ "
                                 "above the static split")
        phis.append(phi)
        static_phis.append(int(static.max()))
        queue = np.maximum(queue + a.sum(axis=0) - drain, 0)
    counts = dict(wl.COUNTS)
    emit({
        "phase": "moe_balance",
        "experts": MOE_EXPERTS,
        "top_k": MOE_TOP_K,
        "devices": MOE_DEVICES,
        "replicas": MOE_REPLICAS,
        "token_slots_per_step": slots,
        "steps": MOE_STEPS,
        "card_ms_per_call": sorted(card_s)[len(card_s) // 2] * 1e3,
        "card_ms_first_call": card_s[0] * 1e3,
        "plain_cpu_ms_per_call": sorted(plain_s)[len(plain_s) // 2] * 1e3,
        "phi_mean": float(np.mean(phis)),
        "static_phi_mean": float(np.mean(static_phis)),
        "launches": counts,
        "identical_to_plain": True,
        "source": "src/repro/configs/deepseek_v3_671b.py:26 (256 routed experts, top-8); "
        "DeepSeek-V3 technical report Sec. 3.4 (prefill unit: 32 GPUs, EP32)",
    })
    # the plain loop's water level runs once a group: MOE_EXPERTS a CPU call
    if counts["wf_groups"] != MOE_STEPS or counts["plain"] != MOE_STEPS * MOE_EXPERTS:
        raise AssertionError(f"moe_balance: {counts} for {MOE_STEPS} card and plain calls")
    return {"launches": {"wf_fused": counts["wf_groups"], "rd_step": 0}}


def _observed_serve_requests(cfg, seed: int) -> list:
    rng = np.random.default_rng(seed + 70)
    lo, hi = OBSERVED_SERVE_PROMPT
    return [Request(i, rng.integers(1, cfg.vocab, int(rng.integers(lo, hi + 1))
                                    ).astype(np.int32), max_new_tokens=OBSERVED_SERVE_NEW)
            for i in range(OBSERVED_SERVE_REQUESTS)]


def _serve_alone(params, cfg, seed: int, debug: bool) -> tuple[dict, int, float, object]:
    eng = ServeEngine(params, cfg, batch_slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN,
                      eos_token=-1, debug=debug)
    steps = [0]

    def counted(tokens, _decode=eng._decode):
        steps[0] += 1
        return _decode(tokens)

    eng._decode = counted
    reqs = _observed_serve_requests(cfg, seed)
    for r in reqs:
        eng.submit(r)
    done = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while len(done) < len(reqs):
        done += eng.step()
    torch.cuda.synchronize()
    return ({r.request_id: list(r.generated) for r in done}, steps[0],
            time.perf_counter() - t0, eng)


def phase_observed_serve(params, seed: int) -> None:
    """Qwen1.5-4B at full width (the serve main path's weights), one
    ``ServeEngine``: the requests under ``observe()`` with ``debug=True``
    give the tokens of the same requests served without the session and
    the guard; ``device.serve-decode.calls`` equals the decode steps and
    the guard raises nothing."""
    cfg = get_config(SERVE_ARCH)
    want, want_steps, plain_wall, _ = _serve_alone(params, cfg, seed, debug=False)
    _reset_model_counts()
    with obs.observe() as session:
        got, steps, wall, eng = _serve_alone(params, cfg, seed, debug=True)
    counts = _model_counts()
    m = session.metrics
    calls = m.counter("device.serve-decode.calls")
    emit({
        "phase": "observed_serve",
        "arch": SERVE_ARCH,
        "layers": cfg.n_layers,
        "dtype": cfg.dtype,
        "requests": OBSERVED_SERVE_REQUESTS,
        "decode_steps": steps,
        "profiled_calls": calls,
        "device": _device_split(m),
        "observed_guarded_wall_s": wall,
        "plain_wall_s": plain_wall,
        "ms_per_decode_step": wall / steps * 1e3,
        "plain_ms_per_decode_step": plain_wall / want_steps * 1e3,
        "guard_armed": eng._guard is not None,
        "launches": counts,
        "tokens_equal_unobserved": got == want,
        "reduced": {"traffic": f"{OBSERVED_SERVE_REQUESTS} requests, prompts "
                    f"{OBSERVED_SERVE_PROMPT[0]}-{OBSERVED_SERVE_PROMPT[1]} tokens, "
                    f"{OBSERVED_SERVE_NEW} new each"},
    })
    if got != want or any(len(t) != OBSERVED_SERVE_NEW for t in got.values()):
        raise AssertionError("observed_serve: tokens differ from the unobserved engine's")
    if calls != steps or steps != want_steps or eng._guard is None or len(eng._guard):
        raise AssertionError(f"observed_serve: {calls} profiled decode steps of {steps}")
    if any(c["plain"] for c in counts.values()) or counts["rmsnorm"]["rmsnorm"] != (
            _norms_per_step(cfg) * steps):
        raise AssertionError(f"observed_serve went around the kernels: {counts}")


def phase_contracts() -> dict:
    """Each of the eight kernel contracts at every geometry the run
    launched: its shared memory and threads equal the block the wrapper
    launched with, its static shared memory the compiled kernel's, all
    within the card's opt-in shared memory, which is kernelcheck's
    default budget; then kernelcheck itself."""
    optin = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    by_kernel = {
        "waterlevel": ("waterlevel.kernel", "waterlevel.kernel-batch"),
        "wf_fused": ("wf_torch.groups", "wf_torch.batch", "wf_torch.chain"),
        "rd_step": ("rd.step", "rd_torch.device", "rd_torch.chain"),
    }
    checked = {name: [] for names in by_kernel.values() for name in names}
    launched = [(kernel, {"m": n, "k": 1, "b": 1, "requested": "cuda"}, cfg,
                 wl.kernel_attributes(kernel == "wf_fused", n))
                for (kernel, n), cfg in sorted(wl.LAUNCH_CONFIGS.items())]
    rd_attrs = rdk.kernel_attributes()
    launched += [("rd_step", {"c": c, "a": a, "m": m, "device": "cuda", "b": 1}, cfg, rd_attrs)
                 for (c, a, m), cfg in sorted(rdk.LAUNCH_CONFIGS.items())]
    for kernel, geom, cfg, (static, max_threads) in launched:
        for name in by_kernel[kernel]:
            declared = CONTRACTS[name].smem(dict(geom))
            if (declared != cfg or declared.static_smem != static
                    or declared.threads > max_threads or declared.smem_bytes > optin):
                raise AssertionError(f"contracts: {name} at {geom} declares {declared}; the "
                                     f"launch took {cfg}, the kernel {static} B static, "
                                     f"{max_threads} threads, opt-in {optin} B")
            checked[name].append(
                {k: v for k, v in geom.items() if k in ("m", "c", "a")}
                | {"smem_bytes": cfg.smem_bytes, "threads": cfg.threads})
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        rc = kernelcheck.main(["--report", str(Path(tmp) / "KERNELCHECK_TORCH.json"),
                               "--max-eval", "1"])
        kc_s = time.perf_counter() - t0
    emit({
        "phase": "contracts",
        "smem_optin_bytes": optin,
        "kernelcheck_budget_bytes": kernelcheck.DEFAULT_BUDGET_BYTES,
        "geometries": {name: len(g) for name, g in checked.items()},
        "largest": {name: max(g, key=lambda x: x["smem_bytes"]) for name, g in checked.items()
                    if g},
        "kernelcheck_rc": rc,
        "kernelcheck_s": kc_s,
    })
    if optin != kernelcheck.DEFAULT_BUDGET_BYTES or rc != 0:
        raise AssertionError(f"contracts: opt-in {optin} B, kernelcheck budget "
                             f"{kernelcheck.DEFAULT_BUDGET_BYTES} B, kernelcheck exit {rc}")
    if not all(checked.values()):
        raise AssertionError(f"contracts: a contract's kernel never launched: "
                             f"{ {k: len(v) for k, v in checked.items()} }")
    return {name: len(g) for name, g in checked.items()}


def _time_rd_iterations(st0, step, n: int) -> dict:
    """``n`` deletion iterations of ``step`` from clones of ``st0``: CUDA
    events around them (``event_ms``, per iteration), and their device
    time under the profiler (``device_ms``, per iteration, every kernel
    summed)."""
    st = st0.clone()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(n):
        step(st, False)
    end.record()
    end.synchronize()
    wall = (time.perf_counter() - t0) / n
    st = st0.clone()
    device = profile_device_us(lambda: [step(st, False) for _ in range(n)], cpu_ops=False)
    return {"event_ms": start.elapsed_time(end) / n, "host_wall_ms": wall * 1e3,
            "device_ms": sum(device.values()) / n / 1e3 if device else None}


def phase_rd_timings(seed: int, admitted: list) -> dict:
    """The RD step kernel on the main path: a chain of the main path's
    problems as the engine handed them over (one pre-burst busy vector),
    its host wall, then under the profiler for device time per launch and
    the card's busy share; then the first of them, kernel against plain
    iteration over the same deletion iterations from the same state."""
    problems = admitted[RD_PROFILED_BURST][RD_PROFILED_JOBS]
    rdk.reset_counts()
    rd_torch.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = rd_torch.replica_deletion_torch_chain(problems)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = rdk.COUNTS["rd_step"]
    runs = list(rd_torch.ITERATIONS)
    if rd_torch.COUNTS["host_reruns"] or rdk.COUNTS["plain"]:
        raise AssertionError(f"the profiled chain went around the kernel: {rdk.COUNTS}")
    for a, b in zip(got, host_commit_walk(problems)):
        if a.alloc != b.alloc or a.phi != b.phi:
            raise AssertionError("replica_deletion_torch_chain differs from host rd")
    t0 = time.perf_counter()
    device = profile_device_us(
        lambda: rd_torch.replica_deletion_torch_chain(problems), cpu_ops=False
    )
    profile_s = time.perf_counter() - t0
    device_ms = {key: v / 1e3 for key, v in device.items()}
    total = sum(device_ms.values())
    step_ms = sum(v for k, v in device_ms.items() if "rd_step" in k)
    # the bound: each run's bytes per iteration over HBM, over its iterations
    nbytes = sum(n * rd_step_bytes(c, a, M_SERVERS) for c, a, n in runs)
    bound_ms = nbytes / HBM_BYTES_PER_S / launches * 1e3

    # kernel and plain iteration over the same deletion iterations
    st0 = rd_torch.initial_rd_state(problems[0])
    n = RD_TIMED_ITERATIONS
    kernel = _time_rd_iterations(st0, rdk.rd_step, n)
    plain = _time_rd_iterations(st0, rdk.rd_step_plain, n)
    row = {
        "chain": f"burst {RD_PROFILED_BURST + 1}, jobs "
        f"{RD_PROFILED_JOBS.start + 1}-{RD_PROFILED_JOBS.stop}",
        "chain_jobs": len(problems),
        "chain_runs": runs,  # (slots, row ids, iterations) per loop pair
        "chain_ms": wall_ms,
        "chain_launches": launches,
        "chain_host_wall_per_iteration_us": wall_ms / launches * 1e3,
        "profile_s": profile_s,
        "chain_device_ms": total,
        "chain_device_busy_share": total / wall_ms if total else None,
        "kernel_ms": step_ms / launches if step_ms else None,
        "bound_ms": bound_ms,
        "bound_by": "bytes",
        "chain_device_ms_by_kernel": dict(
            sorted(device_ms.items(), key=lambda kv: -kv[1])[:8]
        ),
        "same_iterations": {
            "iterations": n,
            "slots": st0.c_slots,
            "row_ids": st0.row_ids,
            "bound_ms": rd_step_bytes(st0.c_slots, st0.row_ids, M_SERVERS)
            / HBM_BYTES_PER_S * 1e3,
            "kernel": kernel,
            "plain": plain,
        },
        "plain_ms": plain["device_ms"],
    }
    if row["kernel_ms"] is None:  # the profiler recorded no device time
        row["kernel_ms"] = kernel["event_ms"]
        emit({"phase": "timing_fallback", "reason": "torch.profiler recorded no rd_step time",
              "event_ms": kernel["event_ms"]})
    emit({"phase": "rd_timings", **row})
    return row


def _fused_calls(bursts: list) -> tuple[list, list]:
    """The main path's fused launches as argument tuples on the card, from
    an empty cluster: single-job calls (one problem, K groups) from the
    trace's first jobs, and chained bursts (B jobs) from its first
    multi-job bursts."""
    busy = np.zeros(M_SERVERS, np.int64)
    dev = torch.device("cuda")

    def staged(problems):
        k = max(len(p.groups) for p in problems)
        return [torch.from_numpy(x).to(dev) for x in wf_torch._dense_inputs(problems, k)]

    jobs = [j for burst in bursts for j in burst][:FUSED_TIMED_SINGLES]
    singles = [tuple(staged([AssignmentProblem(busy=busy, mu=j.mu, groups=j.groups)]))
               for j in jobs]
    chains = []
    for burst in [b for b in bursts if len(b) > 1][:FUSED_TIMED_CHAINS]:
        b0, mu, masks, demands = staged(
            [AssignmentProblem(busy=busy, mu=j.mu, groups=j.groups) for j in burst])
        chains.append((b0[0].contiguous(), mu, masks, demands))
    return singles, chains


def _time_fused(calls: list, kernel, plain) -> dict:
    """Device µs per call of the fused kernel and of its plain loop on the
    same calls, in turns kernel, plain, plain, kernel, from the profiler
    (the fused kernel's own time; every kernel of the plain loop); CUDA
    events over the back-to-back calls for the host-paced rate."""
    def run(fn):
        return lambda: [fn(*a) for a in calls]

    def device_us(fn, name=None):
        for _ in range(2):  # one more try where the profiler recorded nothing
            d = profile_device_us(run(fn), cpu_ops=False)
            if name is not None:
                d = {k: v for k, v in d.items() if name in k}
            if d:
                break
        else:
            ms = cuda_ms(run(fn), 2)
            emit({"phase": "timing_fallback", "reason": "torch.profiler recorded no "
                  "fused-kernel time", "event_ms": ms})
            return ms * 1e3 / len(calls)
        return sum(d.values()) / len(calls)

    run(kernel)()
    run(plain)()
    k1 = device_us(kernel, "wf_fused")
    p1 = device_us(plain)
    p2 = device_us(plain)
    k2 = device_us(kernel, "wf_fused")
    steps = sum(a[2].shape[0] * a[2].shape[1] for a in calls)
    bound, by = fused_bound_ms(calls)
    return {
        "calls": len(calls),
        "group_steps": steps,
        "kernel_ms": (k1 + k2) / 2e3,
        "kernel_us_runs": [k1, k2],
        "kernel_us_per_group_step": (k1 + k2) / 2 * len(calls) / steps,
        "plain_ms": (p1 + p2) / 2e3,
        "plain_us_runs": [p1, p2],
        "plain_us_per_group_step": (p1 + p2) / 2 * len(calls) / steps,
        "kernel_event_ms": cuda_ms(run(kernel), 3) / len(calls),
        "bound_ms": bound,
        "bound_by": by,
    }


def phase_timings(seed: int, bursts: list) -> dict:
    """K1/K2 at the shapes of earlier runs (10 live lanes a row), the fused
    kernel on the main path's single-job calls and chained bursts, and the
    chained burst admission's wall time and device busy share."""
    rng = np.random.default_rng(seed + 2)
    rows = []
    out = {}
    t_phase = time.perf_counter()
    for n, bsz in TIMED:
        b, w, d = main_path_rows(rng, n, bsz)
        iters = 200 if n <= 4096 else 50

        def kernel():
            return wl.waterlevel_sorted(b, w, d)

        def plain():
            return wl.waterlevel_sorted_plain(b, w, d)

        # interleaved kernel, plain, plain, kernel on the same inputs: device
        # time per call under the profiler (a launch now takes less device
        # time than the wrapper's host side, so CUDA events over back-to-back
        # calls, kept as *_event_ms, measure the host's rate)
        k1 = device_ms_per_call(kernel, iters)
        p1 = device_ms_per_call(plain, iters)
        p2 = device_ms_per_call(plain, iters)
        k2 = device_ms_per_call(kernel, iters)
        bound, bound_by = card_bound_ms(n, [10] * bsz)
        row = {
            "n_lanes": n,
            "batch": bsz,
            "live_lanes_per_row": 10,
            "kernel_ms": (k1 + k2) / 2,
            "kernel_ms_runs": [k1, k2],
            "plain_ms": (p1 + p2) / 2,
            "plain_ms_runs": [p1, p2],
            "kernel_event_ms": cuda_ms(kernel, iters),
            "plain_event_ms": cuda_ms(plain, iters),
            "bound_ms": bound,
            "bound_by": bound_by,
        }
        rows.append(row)
        out[(n, bsz)] = row

    seconds = {"k1_k2": time.perf_counter() - t_phase}
    singles, chains = _fused_calls(bursts)
    out["fused single"] = _time_fused(singles, wl.wf_groups, wl.wf_groups_plain)
    seconds["fused_single"] = time.perf_counter() - t_phase - sum(seconds.values())
    out["fused chain"] = _time_fused(chains, wl.wf_chain, wl.wf_chain_plain)
    seconds["fused_chain"] = time.perf_counter() - t_phase - sum(seconds.values())

    # chained burst admission through the adapter: host wall per call (each
    # ends in one .cpu()), then the same calls under the profiler for
    # device time
    busy = np.zeros(M_SERVERS, np.int64)
    calls = [
        [AssignmentProblem(busy=busy, mu=j.mu, groups=j.groups) for j in burst]
        for burst in bursts
        if len(burst) > 1
    ][:FUSED_TIMED_CHAINS]
    wl.reset_counts()
    t0 = time.perf_counter()
    for problems in calls:
        wf_torch.water_filling_torch_chain(problems)
    chain_ms = (time.perf_counter() - t0) / len(calls) * 1e3
    launches = _fused_launches(wl.COUNTS) / len(calls)
    device = profile_device_us(
        lambda: [wf_torch.water_filling_torch_chain(p) for p in calls]
    )
    device_ms = {k: v / len(calls) / 1e3 for k, v in device.items()}
    total = sum(device_ms.values())
    seconds["chain_admission"] = time.perf_counter() - t_phase - sum(seconds.values())
    emit({
        "phase": "timings",
        "seconds": seconds,
        "kernels": rows,
        "fused_single_job": out["fused single"],
        "fused_chain": out["fused chain"],
        "chain_ms_per_burst": chain_ms,
        "chain_bursts": len(calls),
        "chain_fused_launches_per_burst": launches,
        "chain_device_ms_per_burst": total,
        "chain_device_busy_share": total / chain_ms if total else None,
        "chain_device_ms_per_burst_by_kernel": dict(
            sorted(device_ms.items(), key=lambda kv: -kv[1])[:8]
        ),
    })
    return out


def profile_device_us(fn, cpu_ops: bool = True) -> dict[str, float]:
    """Device time per kernel name (µs) over one run of ``fn``, from
    ``torch.profiler``; empty when the profiler records no device time.
    ``cpu_ops=False`` leaves the host-side op events out (a third of the
    events to record and aggregate)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA]
    if cpu_ops:
        activities.append(ProfilerActivity.CPU)
    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        fn()
        torch.cuda.synchronize()
    out: dict[str, float] = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", 0.0)
        if us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            out[ev.key] = out.get(ev.key, 0.0) + us
    return out


# ---- the dense model: kernels, serving and prefill ---------------------------


def _model_counts() -> dict[str, dict[str, int]]:
    return {
        "rmsnorm": dict(rnk.COUNTS),
        "decode_attention": dict(dak.COUNTS),
        "flash_attention": dict(fak.COUNTS),
        "ssd_scan": dict(ssk.COUNTS),
        "waterlevel": dict(wl.COUNTS),
    }


def _reset_model_counts() -> None:
    for mod in (rnk, dak, fak, ssk, wl):
        mod.reset_counts()


# the kernels each family's serve parity run (prefill + engine) launches
FAMILY_KERNELS = {
    "dense": ("rmsnorm", "decode_attention", "flash_attention"),
    "moe": ("rmsnorm", "decode_attention", "flash_attention"),
    "mla_moe": ("rmsnorm",),  # MLA calls no attention kernel, as the reference's
    "mamba2": ("rmsnorm", "ssd_scan"),
    "zamba2": ("rmsnorm", "decode_attention", "flash_attention", "ssd_scan"),
}


def _sms() -> int:
    return torch.cuda.get_device_properties(0).multi_processor_count


def _randn(gen: torch.Generator, shape, dtype) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device="cuda", dtype=torch.float32).to(dtype)


def _model_err(got: torch.Tensor, want: torch.Tensor, dtype_name: str) -> tuple[float, bool]:
    """Largest |kernel - plain| and whether every element is within the
    dtype's tolerance (atol + rtol * |plain|)."""
    atol, rtol = MODEL_TOL[dtype_name]
    diff = (got.float() - want.float()).abs()
    ok = bool((diff <= atol + rtol * want.float().abs()).all())
    return float(diff.max()), ok


def phase_model_kernels(seed: int) -> dict[str, float]:
    """K4, K5 and K6 against their plain versions on the card; returns the
    largest error per kernel (each case also within its tolerance)."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 10)
    cfg = get_config(SERVE_ARCH)
    d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    q3 = get_config("qwen3-32b")
    worst = {"rmsnorm": 0.0, "decode_attention": 0.0, "flash_attention": 0.0}
    cases = []
    for dtype_name in ("float32", "bfloat16"):
        dt = getattr(torch, dtype_name)
        for label, shape in (
            ("decode rows", (SERVE_SLOTS, 1, d)),
            ("prefill rows", (PREFILL_BATCH, PREFILL_LEN, d)),
            ("qk-norm rows", (PREFILL_BATCH, 2049, q3.n_heads, q3.head_dim_)),
            ("mamba2 width", (PREFILL_BATCH, PREFILL_LEN, get_config("mamba2-130m").d_model)),
            ("tail rows", (3, 7, 1000)),
            ("d off the vector", (300, d + 2)),
            ("unaligned rows", (300, d)),
        ):
            g = _randn(gen, shape[-1:], dt)
            if label == "unaligned rows":  # rows one element past a 16-byte boundary
                x = _randn(gen, (int(np.prod(shape)) + 1,), dt)[1:].view(shape)
            else:
                x = _randn(gen, shape, dt)
            err, ok = _model_err(rnk.rmsnorm(x, g, cfg.norm_eps),
                                 rnk.rmsnorm_plain(x, g, cfg.norm_eps), dtype_name)
            cases.append({"kernel": "rmsnorm", "case": label, "shape": list(shape),
                          "dtype": dtype_name, "route": rnk.route(x, g),
                          "max_abs_err": err, "ok": ok})
        sms = _sms()
        chunk, splits = dak.split_plan(SERVE_SLOTS, hkv, SERVE_MAX_LEN, sms)
        qm = get_config("qwen3-moe-235b-a22b")
        moe_heads = (qm.n_heads, qm.n_kv_heads)
        chunk16, splits16 = dak.split_plan(SERVE_SLOTS, qm.n_kv_heads, SERVE_MAX_LEN, sms,
                                           qm.n_heads // qm.n_kv_heads)
        for label, (b, nh, nkv, t, dh), pos in (
            ("qwen3-moe heads (group 16)", (SERVE_SLOTS, *moe_heads, SERVE_MAX_LEN,
                                            qm.head_dim_), None),
            ("group 16, chunk and split boundaries",
             (SERVE_SLOTS, *moe_heads, SERVE_MAX_LEN, qm.head_dim_),
             [chunk16 - 1, chunk16, splits16 * chunk16 - 1, splits16 * chunk16]),
            ("group 16, pos 0 and pos >= T", (SERVE_SLOTS, *moe_heads, SERVE_MAX_LEN,
                                              qm.head_dim_),
             [0, SERVE_MAX_LEN - 1, SERVE_MAX_LEN, 10**6]),
            ("group 12 (slices of 6)", (3, 24, 2, 700, hd), None),
            ("serve", (SERVE_SLOTS, h, hkv, SERVE_MAX_LEN, hd), None),
            ("qwen3-32b heads", (SERVE_SLOTS, q3.n_heads, q3.n_kv_heads, SERVE_MAX_LEN,
                                 q3.head_dim_), None),
            ("tail T=1000", (3, h, hkv, 1000, hd), None),
            ("chunk and split boundaries", (SERVE_SLOTS, h, hkv, SERVE_MAX_LEN, hd),
             [chunk - 1, chunk, splits * chunk - 1, splits * chunk]),
            ("pos 0: one split", (SERVE_SLOTS, h, hkv, SERVE_MAX_LEN, hd), [0] * SERVE_SLOTS),
            ("pos >= T", (SERVE_SLOTS, h, hkv, SERVE_MAX_LEN, hd),
             [SERVE_MAX_LEN - 1, SERVE_MAX_LEN, SERVE_MAX_LEN + 1, 10**6]),
            ("long cache T=8192", (1, q3.n_heads, q3.n_kv_heads, 8192, q3.head_dim_), None),
        ):
            q = _randn(gen, (b, nh, dh), dt)
            k, v = _randn(gen, (b, nkv, t, dh), dt), _randn(gen, (b, nkv, t, dh), dt)
            if pos is None:
                pos = torch.randint(0, t, (b,), generator=gen, device="cuda", dtype=torch.int32)
                pos[0] = 0
                pos[-1] = t - 1
            else:
                pos = torch.tensor(pos, dtype=torch.int32, device="cuda")
            err, ok = _model_err(dak.decode_attention(q, k, v, pos),
                                 dak.decode_attention_plain(q, k, v, pos), dtype_name)
            cases.append({"kernel": "decode_attention", "case": label,
                          "shape": [b, nh, nkv, t, dh],
                          "chunk_splits": dak.split_plan(b, nkv, t, sms, nh // nkv),
                          "slices": dak.group_slices(nh // nkv),
                          "dtype": dtype_name, "max_abs_err": err, "ok": ok})
        flash = [
            ("prefill", (PREFILL_BATCH, h, hkv, PREFILL_LEN, PREFILL_LEN, hd), True),
            ("qwen3-32b heads (GQA 8)", (1, q3.n_heads, q3.n_kv_heads, 1024, 1024,
                                         q3.head_dim_), True),
            ("qwen3-moe heads (GQA 16)", (1, *moe_heads, 1024, 1024, qm.head_dim_), True),
            ("tail S=2049", (1, h, hkv, PREFILL_LEN + 1, PREFILL_LEN + 1, hd), True),
            ("tail S=2049, not causal", (1, h, hkv, PREFILL_LEN + 1, PREFILL_LEN + 1, hd),
             False),
            ("T > S, not causal", (2, 8, 2, 200, 777, hd), False),
            ("S > T, causal", (2, 8, 2, 777, 200, hd), True),
        ]
        flash += [(f"hd {w}, ragged S=T=300", (2, 16, 2, 300, 300, w), True)
                  for w in fak.HEAD_DIMS]
        for label, (b, nh, nkv, sl, tl, dh), causal in flash:
            q = _randn(gen, (b, nh, sl, dh), dt)
            k, v = _randn(gen, (b, nkv, tl, dh), dt), _randn(gen, (b, nkv, tl, dh), dt)
            err, ok = _model_err(fak.flash_attention(q, k, v, causal=causal),
                                 fak.flash_attention_plain(q, k, v, causal=causal),
                                 dtype_name)
            cases.append({"kernel": "flash_attention", "case": label,
                          "shape": [b, nh, nkv, sl, tl, dh], "causal": causal,
                          "route": fak.route(dt, dh), "dtype": dtype_name,
                          "max_abs_err": err, "ok": ok})
        # the model's layout: q, k and v as transposed (B, S, H, hd) views of
        # one projection's rows
        b, sl = 2, 300
        qkv = _randn(gen, (b, sl, (h + 2 * hkv) * hd), dt)
        q = qkv[..., : h * hd].reshape(b, sl, h, hd).transpose(1, 2)
        k = qkv[..., h * hd : (h + hkv) * hd].reshape(b, sl, hkv, hd).transpose(1, 2)
        v = qkv[..., (h + hkv) * hd :].reshape(b, sl, hkv, hd).transpose(1, 2)
        err, ok = _model_err(fak.flash_attention(q, k, v),
                             fak.flash_attention_plain(q.contiguous(), k.contiguous(),
                                                       v.contiguous()), dtype_name)
        cases.append({"kernel": "flash_attention", "case": "strided (B, S, H, hd) views",
                      "shape": [b, h, hkv, sl, sl, hd], "causal": True,
                      "route": fak.route(dt, hd), "dtype": dtype_name, "max_abs_err": err,
                      "ok": ok})
    torch.cuda.synchronize()
    for c in cases:
        worst[c["kernel"]] = max(worst[c["kernel"]], c["max_abs_err"])
    emit({
        "phase": "model_kernels",
        "held": list(worst),
        "tolerance": {k: {"atol": a, "rtol": r} for k, (a, r) in MODEL_TOL.items()},
        "cases": cases,
        "max_abs_err": worst,
    })
    bad = [c for c in cases if not c["ok"]]
    if bad:
        raise AssertionError(f"model kernels disagree with their plain versions: {bad}")
    return worst


def phase_serve_parity(
    seed: int,
    archs: tuple[str, ...] = ("qwen1.5-4b", "qwen3-32b"),
    phase: str = "serve_parity",
    logit_tol: float | None = None,
) -> None:
    """Smoke configs in float32, the same seeded weights: the port's
    ServeEngine and prefill + decode on the card against the port on the
    CPU; identical tokens, and (with ``logit_tol``) logits within it."""
    rows = []
    for arch in archs:
        cfg = get_smoke_config(arch)
        with set_backend(device="cpu"):
            cpu_params = init_params(torch.Generator().manual_seed(seed), cfg)
        rng = np.random.default_rng(seed + 20)
        reqs = [(i, rng.integers(1, cfg.vocab, int(rng.integers(2, 40))).astype(np.int32),
                 int(rng.integers(4, 12))) for i in range(6)]
        prompt = torch.from_numpy(rng.integers(1, cfg.vocab, (2, 150)).astype(np.int32))
        steps = [torch.from_numpy(rng.integers(1, cfg.vocab, (2, 1)).astype(np.int32))
                 for _ in range(4)]
        tokens, logits = {}, {}
        for dev in ("cpu", "cuda"):
            params = cpu_params if dev == "cpu" else copy.deepcopy(cpu_params).to(dev)
            with set_backend(device=dev):
                _reset_model_counts()
                eng = ServeEngine(params, cfg, batch_slots=2, max_len=256, eos_token=-1)
                for rid, p, n in reqs:
                    eng.submit(Request(rid, p.copy(), max_new_tokens=n))
                done = []
                while len(done) < len(reqs):
                    done += eng.step()
                tokens[dev] = {r.request_id: r.generated for r in done}
                out, cache = prefill(params, cfg, {"tokens": prompt.to(dev)}, max_len=160)
                got = [out]
                for tok in steps:
                    out, cache = decode_step(params, cfg, tok.to(dev), cache)
                    got.append(out)
                logits[dev] = torch.cat([x.cpu() for x in got], 1)
                counts = _model_counts()
            if dev == "cuda":
                card_counts = counts
        err = float((logits["cuda"] - logits["cpu"]).abs().max())
        identical = tokens["cuda"] == tokens["cpu"]
        rows.append({"arch": arch, "requests": len(reqs), "identical_tokens": identical,
                     "max_abs_logit_err": err, "card_launches": card_counts})
        if not identical:
            raise AssertionError(f"{arch}: tokens on the card differ from the CPU")
        if logit_tol is not None and err > logit_tol:
            raise AssertionError(f"{arch}: logits on the card differ from the CPU by {err}")
        for name in FAMILY_KERNELS[cfg.block_pattern]:
            if card_counts[name][name] == 0 or card_counts[name]["plain"] != 0:
                raise AssertionError(f"{arch}: serve parity on the card bypassed {name}")
    emit({"phase": phase, "dtype": "float32", "logit_tolerance": logit_tol, "rows": rows})


def _attn_per_step(cfg) -> int:
    """K5 launches of one decode step: one per GQA attention layer, or per
    use of zamba2's shared block; none for MLA (plain PyTorch, as the
    reference's jnp) or mamba2."""
    if cfg.block_pattern == "zamba2":
        return cfg.n_layers // cfg.hybrid_period
    return 0 if cfg.block_pattern in ("mamba2", "mla_moe") else cfg.n_layers


def _norms_per_step(cfg) -> int:
    """K4 launches of one decode step (or prefill): two per layer (norm1
    and norm2, or a Mamba2 layer's norm1 and gated norm), two more per
    layer for qk-norm (q and k) or MLA (its q and kv low-rank norms), two
    per use of zamba2's shared block, the final norm."""
    uses = _attn_per_step(cfg) if cfg.block_pattern == "zamba2" else 0
    extra = 2 * cfg.n_layers if cfg.qk_norm or cfg.block_pattern == "mla_moe" else 0
    return 2 * cfg.n_layers + extra + 2 * uses + 1


def phase_serve(arch: str, seed: int, replicas: int, n_requests: int,
                prompt: tuple[int, int], n_new: int, phase: str, cfg=None,
                reduced: dict | None = None) -> tuple[dict, object]:
    """``arch`` at full width (bf16, random seeded weights; ``cfg`` a
    depth-cut config of it) serving ``n_requests``: through one
    ``ServeEngine``, or ``replicas`` of them sharing the weights behind a
    ``wf_torch``-routed ``RoutedServePool``.  Every request finishes with
    its tokens, each decode step launches exactly its K4 and K5 count,
    and nothing takes a plain version."""
    cfg = cfg or get_config(arch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(torch.Generator(device="cuda").manual_seed(seed), cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    engines = {
        i: ServeEngine(params, cfg, batch_slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN,
                       eos_token=-1)
        for i in range(replicas)
    }
    steps = [0]
    finite = []  # each decode step's all-finite flag, read once at the end
    for eng in engines.values():  # count the decode steps the engines run
        def counted(tokens, _decode=eng._decode):
            steps[0] += 1
            logits = _decode(tokens)
            finite.append(torch.isfinite(logits).all())
            return logits
        eng._decode = counted
    rng = np.random.default_rng(seed + 30)
    reqs = [
        Request(i, rng.integers(1, cfg.vocab, int(rng.integers(prompt[0], prompt[1] + 1))
                                ).astype(np.int32), max_new_tokens=n_new)
        for i in range(n_requests)
    ]
    torch.cuda.synchronize()
    _reset_model_counts()
    t0 = time.perf_counter()
    done, slots = [], 0
    if replicas > 1:
        pool = RoutedServePool(engines, ReplicaRouter(replicas, policy="wf_torch"))
        placed = [pool.submit(r) for r in reqs]
        while pool.busy():
            done += pool.step()
            slots += 1
    else:
        for r in reqs:
            engines[0].submit(r)
        placed = [0] * len(reqs)
        while len(done) < len(reqs) and slots < 10_000:
            done += engines[0].step()
            slots += 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _model_counts()
    n = steps[0]
    logits_finite = bool(torch.stack(finite).all()) if finite else False
    prompt_tokens = sum(len(r.prompt) for r in reqs)
    new_tokens = sum(len(r.generated) for r in done)
    emit({
        "phase": phase,
        "arch": arch,
        "layers": cfg.n_layers,
        "dtype": cfg.dtype,
        "params": sum(p.numel() for p in params.parameters()),
        "init_params_s": init_s,
        "replicas": replicas,
        "batch_slots": SERVE_SLOTS,
        "max_len": SERVE_MAX_LEN,
        "requests": len(reqs),
        "prompt_tokens": prompt_tokens,
        "replica_of_request": placed,
        "finished": len(done),
        "new_tokens": new_tokens,
        "pool_steps": slots,
        "decode_steps": n,
        "wall_s": wall,
        "new_tokens_per_s": new_tokens / wall,
        "tokens_per_s": (prompt_tokens + new_tokens) / wall,
        "ms_per_decode_step": wall / n * 1e3 if n else None,
        "launches": counts,
        "rmsnorm_per_step": counts["rmsnorm"]["rmsnorm"] / n if n else None,
        "decode_attention_per_step": counts["decode_attention"]["decode_attention"] / n
        if n else None,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "logits_finite": logits_finite,
        "reduced": {"traffic": f"{n_requests} requests, prompts "
                    f"{prompt[0]}-{prompt[1]} tokens, {n_new} new each", **(reduced or {})},
    })
    if not logits_finite:
        raise AssertionError(f"{phase}: a decode step gave non-finite logits")
    if len(done) != len(reqs) or any(len(r.generated) != n_new for r in done):
        raise AssertionError(f"{phase}: a request did not finish with its tokens")
    if n == 0 or any(c["plain"] for c in counts.values()):
        raise AssertionError(f"{phase} went around the kernels: {counts}")
    if counts["rmsnorm"]["rmsnorm"] != _norms_per_step(cfg) * n:
        raise AssertionError(f"{phase}: {counts['rmsnorm']} RMSNorm launches for {n} "
                             f"decode steps")
    if counts["decode_attention"]["decode_attention"] != _attn_per_step(cfg) * n:
        raise AssertionError(f"{phase}: {counts['decode_attention']} decode-attention "
                             f"launches for {n} decode steps")
    wlc = counts["waterlevel"]
    if replicas > 1 and (wlc["wf_groups"] != len(reqs) or wlc["waterlevel"]
                         or wlc["waterlevel_batch"]):
        raise AssertionError(f"{phase}: routing went around the fused water-filling "
                             f"kernel (one launch per request): {counts}")
    return counts, params


def phase_decode_profile(params, seed: int, arch: str = SERVE_ARCH,
                         phase: str = "decode_profile", cfg=None) -> None:
    """Where one decode step's time goes: host wall against device time
    under torch.profiler, at the serving shape (4 slots, ~300 cached
    positions)."""
    cfg = cfg or get_config(arch)
    eng = ServeEngine(params, cfg, batch_slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN,
                      eos_token=-1)
    eng._pos[:] = 300
    tokens = torch.ones(SERVE_SLOTS, 1, dtype=torch.int32, device="cuda")
    n = 5

    def steps():
        for _ in range(n):
            decode_step(params, cfg, tokens, eng._with_pos())
        torch.cuda.synchronize()

    steps()  # warm up
    t0 = time.perf_counter()
    steps()
    wall_ms = (time.perf_counter() - t0) / n * 1e3
    device = profile_device_us(steps)
    device_ms = {k: v / n / 1e3 for k, v in device.items()}
    total = sum(device_ms.values())
    emit({
        "phase": phase,
        "arch": arch,
        "steps": n,
        "step_wall_ms": wall_ms,
        "step_device_ms": total,
        "device_busy_share": total / wall_ms if total else None,
        "step_device_ms_by_kernel": dict(
            sorted(device_ms.items(), key=lambda kv: -kv[1])[:10]
        ),
    })


def phase_prefill_path(params, seed: int) -> dict:
    """The batched prefill entry point at 2048 tokens (K6 + K4), one decode
    step from its cache, held against a prefill over the 2049 tokens."""
    cfg = get_config(SERVE_ARCH)
    gen = torch.Generator(device="cuda").manual_seed(seed + 40)
    toks = torch.randint(1, cfg.vocab, (PREFILL_BATCH, PREFILL_LEN + 1), generator=gen,
                         device="cuda", dtype=torch.int32)
    step = make_prefill_step(cfg, max_len=PREFILL_MAX_LEN)
    torch.cuda.synchronize()
    _reset_model_counts()
    t0 = time.perf_counter()
    _, cache = step(params, {"tokens": toks[:, :PREFILL_LEN]})
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    counts = _model_counts()
    _reset_model_counts()
    got, _ = decode_step(params, cfg, toks[:, PREFILL_LEN:], cache)
    decode_counts = _model_counts()
    del cache
    _reset_model_counts()
    want, _ = prefill(params, cfg, {"tokens": toks})
    tail_counts = _model_counts()
    got, want = got[:, 0].float(), want[:, 0].float()
    scale = float(want.abs().max())
    rel = float((got - want).abs().max()) / scale
    top2 = want.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > PREFILL_REL_TOL * scale
    agree = got.argmax(-1) == want.argmax(-1)
    emit({
        "phase": "prefill_path",
        "batch": PREFILL_BATCH,
        "prompt_len": PREFILL_LEN,
        "max_len": PREFILL_MAX_LEN,
        "prefill_s": prefill_s,
        "prefill_tokens_per_s": PREFILL_BATCH * PREFILL_LEN / prefill_s,
        "launches": counts,
        "decode_launches": decode_counts,
        "check_prefill_launches": tail_counts,
        "max_abs_logit": scale,
        "max_rel_err": rel,
        "tolerance": PREFILL_REL_TOL,
        "argmax_agree": agree.tolist(),
        "argmax_gap_clear": clear.tolist(),
    })
    if rel > PREFILL_REL_TOL or not bool(agree[clear].all()):
        raise AssertionError("decode after prefill disagrees with prefill over S + 1")
    for name in ("rmsnorm", "flash_attention"):
        if counts[name][name] == 0 or counts[name]["plain"] != 0:
            raise AssertionError(f"prefill path went around {name}: {counts}")
    for label, c in (("the prefill", counts), ("the 2049-token prefill", tail_counts)):
        k6 = c["flash_attention"]
        if k6 != {"flash_attention": cfg.n_layers, "tensor_core": cfg.n_layers, "plain": 0}:
            raise AssertionError(f"{label} did not run K6 on the tensor cores on every "
                                 f"layer: {k6}")
    return counts


def _bound(nbytes: float, ops: float, ops_per_s: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / ops_per_s
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def device_ms_per_call(fn, iters: int) -> float:
    """Device time of one call of ``fn`` (every kernel it launches, summed,
    without the gaps between launches), from ``torch.profiler``.  Where the
    profiler records no device time (seen once, late in a long run), one
    more try, then CUDA events over back-to-back calls, announced on a
    ``timing_fallback`` line: for a call shorter than its launch cost that
    is the host's rate, not the card's."""
    fn()
    for _ in range(2):
        device = profile_device_us(lambda: [fn() for _ in range(iters)], cpu_ops=False)
        if device:
            return sum(device.values()) / iters / 1e3
    ms = cuda_ms(fn, iters)
    emit({"phase": "timing_fallback", "reason": "torch.profiler recorded no device time",
          "event_ms": ms})
    return ms


def _time_three(kernel, plain, library, iters: int) -> dict:
    """Kernel, plain version and library call on the same inputs: device
    time per call under the profiler (the ``*_ms`` the summary reports),
    and CUDA events over back-to-back calls, kernel, plain, library,
    library, plain, kernel (``*_event_ms``: for a call shorter than its
    host-side launch cost, this is the host's rate, not the card's)."""
    k1 = cuda_ms(kernel, iters)
    p1 = cuda_ms(plain, iters)
    l1 = cuda_ms(library, iters)
    l2 = cuda_ms(library, iters)
    p2 = cuda_ms(plain, iters)
    k2 = cuda_ms(kernel, iters)
    return {
        "kernel_ms": device_ms_per_call(kernel, iters),
        "plain_ms": device_ms_per_call(plain, iters),
        "library_ms": device_ms_per_call(library, iters),
        "kernel_event_ms": [k1, k2],
        "plain_event_ms": [p1, p2],
        "library_event_ms": [l1, l2],
    }


def phase_model_timings(seed: int) -> dict:
    """Times of K4/K5/K6 at the serving path's shapes in bf16 (device time
    per call, and CUDA events), beside their plain versions, one PyTorch
    call each and the bound:
    bytes (each input read once, each output written once) over HBM, or
    operations over the peak of their type (fp32 CUDA cores for the
    norm's arithmetic, dense bf16 tensor cores for attention's products),
    whichever is larger."""
    F = torch.nn.functional
    gen = torch.Generator(device="cuda").manual_seed(seed + 50)
    cfg = get_config(SERVE_ARCH)
    d, h, hkv, hd, eps = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_, cfg.norm_eps
    bf16 = torch.bfloat16
    rows = {}
    for label, n_rows in (("rmsnorm decode", 2 * SERVE_SLOTS), ("rmsnorm prefill",
                                                                2 * PREFILL_BATCH * 1024)):
        x, g = _randn(gen, (n_rows, d), bf16), _randn(gen, (d,), bf16)
        t = _time_three(lambda: rnk.rmsnorm(x, g, eps), lambda: rnk.rmsnorm_plain(x, g, eps),
                        lambda: F.rms_norm(x, (d,), g, eps), 200)
        bound, by = _bound(2 * (2 * n_rows * d + d), 4 * n_rows * d, PEAK_32BIT_OPS_PER_S)
        rows[label] = {"shape": [n_rows, d], "route": rnk.route(x, g), **t, "bound_ms": bound,
                       "bound_by": by}
    b, t_len = SERVE_SLOTS, SERVE_MAX_LEN
    q = _randn(gen, (b, h, hd), bf16)
    k, v = _randn(gen, (b, hkv, t_len, hd), bf16), _randn(gen, (b, hkv, t_len, hd), bf16)
    # a full cache, and the decode profile's position (301 keys, as the
    # serve traffic's prompts of 32-256 tokens + 32 new reach)
    for label, at in (("decode_attention", t_len - 1), ("decode_attention 301 keys", 300)):
        pos = torch.full((b,), at, dtype=torch.int32, device="cuda")
        mask = (torch.arange(t_len, device="cuda")[None, :] <= pos[:, None])[:, None, None, :]
        t = _time_three(
            lambda: dak.decode_attention(q, k, v, pos),
            lambda: dak.decode_attention_plain(q, k, v, pos),
            lambda: F.scaled_dot_product_attention(q[:, :, None], k, v, attn_mask=mask,
                                                   enable_gqa=True),
            200,
        )
        keys = int(pos.sum()) + b  # the keys t <= pos this run reads
        bound, by = _bound(2 * (2 * b * h * hd + 2 * keys * hkv * hd) + 4 * b,
                           4 * keys * h * hd, PEAK_BF16_FLOPS)
        rows[label] = {"shape": [b, h, hkv, t_len, hd], "pos": at, **t, "bound_ms": bound,
                       "bound_by": by, "chunk_splits": dak.split_plan(b, hkv, t_len, _sms())}
    # Qwen3-MoE's decode shape: 64 query heads over 4 KV heads (group 16, two
    # slices, each reading the cache: twice the cache bytes of the bound)
    qm = get_config("qwen3-moe-235b-a22b")
    mh, mkv, mhd = qm.n_heads, qm.n_kv_heads, qm.head_dim_
    q = _randn(gen, (b, mh, mhd), bf16)
    k, v = _randn(gen, (b, mkv, t_len, mhd), bf16), _randn(gen, (b, mkv, t_len, mhd), bf16)
    pos = torch.full((b,), t_len - 1, dtype=torch.int32, device="cuda")
    mask = (torch.arange(t_len, device="cuda")[None, :] <= pos[:, None])[:, None, None, :]
    t = _time_three(
        lambda: dak.decode_attention(q, k, v, pos),
        lambda: dak.decode_attention_plain(q, k, v, pos),
        lambda: F.scaled_dot_product_attention(q[:, :, None], k, v, attn_mask=mask,
                                               enable_gqa=True),
        200,
    )
    keys = int(pos.sum()) + b
    bound, by = _bound(2 * (2 * b * mh * mhd + 2 * keys * mkv * mhd) + 4 * b,
                       4 * keys * mh * mhd, PEAK_BF16_FLOPS)
    rows["decode_attention group 16"] = {
        "shape": [b, mh, mkv, t_len, mhd], "pos": t_len - 1, **t, "bound_ms": bound,
        "bound_by": by, "chunk_splits": dak.split_plan(b, mkv, t_len, _sms(), mh // mkv),
        "slices": dak.group_slices(mh // mkv)}
    b, s = PREFILL_BATCH, PREFILL_LEN
    q = _randn(gen, (b, h, s, hd), bf16)
    k, v = _randn(gen, (b, hkv, s, hd), bf16), _randn(gen, (b, hkv, s, hd), bf16)
    t = _time_three(
        lambda: fak.flash_attention(q, k, v, causal=True),
        lambda: fak.flash_attention_plain(q, k, v, causal=True),
        lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True),
        5,
    )
    pairs = b * h * s * (s + 1) // 2  # (query, key) pairs the causal mask keeps
    bound, by = _bound(2 * (2 * b * h * s * hd + 2 * b * hkv * s * hd), 4 * pairs * hd,
                       PEAK_BF16_FLOPS)
    rows["flash_attention"] = {"shape": [b, h, hkv, s, hd], "causal": True, **t,
                               "bound_ms": bound, "bound_by": by}
    emit({"phase": "model_timings", "dtype": "bfloat16", "kernels": rows})
    return rows


# ---- K5 and K6 at every group and head width up to 256 -------------------------


def _k5_bound(b: int, h: int, hkv: int, hd: int, pos: torch.Tensor) -> tuple[float, str]:
    keys = int(pos.clamp(min=0).sum()) + b  # the keys t <= pos this run reads
    return _bound(2 * (2 * b * h * hd + 2 * keys * hkv * hd) + 4 * b, 4 * keys * h * hd,
                  PEAK_BF16_FLOPS)


def _k6_bound(b: int, h: int, hkv: int, s: int, t: int, hd: int,
              causal: bool) -> tuple[float, str]:
    pairs = b * h * sum(min(i + 1, t) for i in range(s)) if causal else b * h * s * t
    return _bound(2 * (2 * b * h * s * hd + 2 * b * hkv * t * hd), 4 * pairs * hd,
                  PEAK_BF16_FLOPS)


def _rotating(fn, args: tuple):
    """``fn`` over copies of ``args`` in turn, so many that the others' bytes
    pass four times the L2 between two uses of one copy: each timed call
    reads its inputs from HBM, where back-to-back calls on one set would
    find them in L2."""
    nbytes = sum(a.numel() * a.element_size() for a in args)
    sets = [args] + [tuple(a.clone() for a in args) for _ in range(-(-4 * L2_BYTES // nbytes))]
    turn = itertools.cycle(sets)
    return lambda: fn(*next(turn))


def _ramp(b: int, h: int, hkv: int, s: int, t: int, hd: int, dt) -> tuple:
    """K6 inputs that make the key mask's faults large: q all ones, k all
    minus ones but half that at the last key (every score -sqrt(hd), the
    last key's half that: -8 and -4 at hd 64), values climbing with the
    key, v[.., j, :] = j / t.  A key past t let through the mask (score 0
    on TMA's zero fill) would take most of the weight; the last key
    masked off would move every output by ~0.018 at t = 1500, a tail of
    92 keys by more."""
    q = torch.ones((b, h, s, hd), device="cuda", dtype=dt)
    k = -torch.ones((b, hkv, t, hd), device="cuda", dtype=dt)
    k[:, :, -1] = -0.5
    ramp = torch.arange(t, device="cuda", dtype=torch.float32) / t
    return q, k, ramp[None, None, :, None].expand(b, hkv, t, hd).to(dt).contiguous()


def _attention_cases(phase: str, gen: torch.Generator, k5: list, k6: list, views: list,
                     timed) -> dict:
    """K5 cases ``(label, (b, h, hkv, t, hd))`` (random positions, the
    first 0 and the last t - 1), K6 cases ``(label, (b, h, hkv, s, t, hd),
    causal)`` (``(..., causal, "ramp")``: :func:`_ramp`'s inputs, the mask's
    check) and K6 causal cases through the model's strided views
    ``(label, (b, h, hkv, s, hd))`` (q, k and v as transposed views of one
    projection's rows), in float32 and bfloat16.  Every kernel call runs
    first, with the counts zeroed: one launch per case and no plain call;
    then each output against its plain version, within the model
    tolerance, and each bf16 output also against the plain version in
    float32 on the same inputs, within ``BF16_F32_REL`` of that output's
    largest magnitude (the model tolerance's atol is ~60 % of a typical
    output over 1500 keys).  Each case's kernel time is CUDA events over
    back-to-back calls; the bf16 cases whose label ``timed`` accepts
    (never the views or ramps) are timed against plain and SDPA too, on
    rotating input copies (:func:`_rotating`), beside their bound.  Emits
    the ``phase`` line; returns the timed rows and the worst error a
    kernel."""
    F = torch.nn.functional
    runs = []
    _reset_model_counts()
    for dtype_name in ("float32", "bfloat16"):
        dt = getattr(torch, dtype_name)
        for label, (b, h, hkv, t, hd) in k5:
            q = _randn(gen, (b, h, hd), dt)
            k, v = _randn(gen, (b, hkv, t, hd), dt), _randn(gen, (b, hkv, t, hd), dt)
            pos = torch.randint(0, t, (b,), generator=gen, device="cuda", dtype=torch.int32)
            pos[0], pos[-1] = 0, t - 1
            args = (q, k, v, pos)
            runs.append(("decode_attention", label, dtype_name, [b, h, hkv, t, hd], None, args,
                         dak.decode_attention(*args)))
        for label, (b, h, hkv, s, t, hd), causal, *inputs in k6:
            if inputs == ["ramp"]:
                q, k, v = _ramp(b, h, hkv, s, t, hd, dt)
            else:
                q = _randn(gen, (b, h, s, hd), dt)
                k, v = _randn(gen, (b, hkv, t, hd), dt), _randn(gen, (b, hkv, t, hd), dt)
            runs.append(("flash_attention", label, dtype_name, [b, h, hkv, s, t, hd], causal,
                         (q, k, v), fak.flash_attention(q, k, v, causal=causal)))
        for label, (b, h, hkv, sl, hd) in views:
            qkv = _randn(gen, (b, sl, (h + 2 * hkv) * hd), dt)
            q = qkv[..., : h * hd].reshape(b, sl, h, hd).transpose(1, 2)
            k = qkv[..., h * hd : (h + hkv) * hd].reshape(b, sl, hkv, hd).transpose(1, 2)
            v = qkv[..., (h + hkv) * hd :].reshape(b, sl, hkv, hd).transpose(1, 2)
            runs.append(("flash_attention", label, dtype_name, [b, h, hkv, sl, sl, hd], True,
                         (q, k, v), fak.flash_attention(q, k, v, causal=True)))
    torch.cuda.synchronize()
    counts = _model_counts()
    n5 = sum(r[0] == "decode_attention" for r in runs)
    n6 = len(runs) - n5
    if (counts["decode_attention"] != {"decode_attention": n5, "decode_attention_partial": 0,
                                       "plain": 0}
            or counts["flash_attention"]["flash_attention"] != n6
            or counts["flash_attention"]["plain"] != 0):
        raise AssertionError(f"{phase}: {n5} K5 and {n6} K6 calls gave counts "
                             f"{counts['decode_attention']} {counts['flash_attention']}")
    untimed = {label for label, _ in views} | {c[0] for c in k6 if c[3:] == ("ramp",)}
    cases, timed_rows = [], {}
    for kernel, label, dtype_name, shape, causal, args, got in runs:
        if kernel == "decode_attention":
            plain, plain_args = dak.decode_attention_plain, args
            call = lambda a=args: dak.decode_attention(*a)  # noqa: E731
            extra = {"slices": dak.group_slices(shape[1] // shape[2]),
                     "lane_plan": dak.lane_plan(shape[4], args[0].element_size())}
        else:
            plain = functools.partial(fak.flash_attention_plain, causal=causal)
            plain_args = tuple(x.contiguous() for x in args)
            call = lambda a=args, c=causal: fak.flash_attention(*a, causal=c)  # noqa: E731
            extra = {"causal": causal, "route": fak.route(args[0].dtype, shape[5])}
        err, ok = _model_err(got, plain(*plain_args), dtype_name)
        if dtype_name == "bfloat16":
            want32 = plain(*(x.float() if x.is_floating_point() else x for x in plain_args))
            tol32 = BF16_F32_REL * float(want32.abs().max())
            err32 = float((got.float() - want32).abs().max())
            extra.update(max_abs_err_f32=err32, tol_f32=tol32)
            ok = ok and err32 <= tol32
        cases.append({"kernel": kernel, "case": label, "dtype": dtype_name, "shape": shape,
                      **extra, "max_abs_err": err, "ok": ok,
                      "kernel_us": cuda_ms(call, 10) * 1e3})
        if dtype_name != "bfloat16" or label in untimed or not timed(label):
            continue
        if kernel == "decode_attention":
            q, k, v, pos = args
            t_len = k.shape[2]
            mask = (torch.arange(t_len, device="cuda")[None, :] <= pos[:, None])[:, None, None]
            t = _time_three(_rotating(dak.decode_attention, args),
                            _rotating(dak.decode_attention_plain, args),
                            _rotating(lambda q, k, v, _: F.scaled_dot_product_attention(
                                q[:, :, None], k, v, attn_mask=mask, enable_gqa=True), args),
                            100)
            bound, by = _k5_bound(*shape[:3], shape[4], pos)
        else:
            t = _time_three(_rotating(functools.partial(fak.flash_attention, causal=causal),
                                      args),
                            _rotating(plain, args),
                            _rotating(functools.partial(F.scaled_dot_product_attention,
                                                        is_causal=causal, enable_gqa=True),
                                      args), 5)
            bound, by = _k6_bound(*shape, causal)
        timed_rows[f"{kernel} {label}"] = {"shape": shape, **t, "bound_ms": bound,
                                           "bound_by": by}
    bad = [c for c in cases if not c["ok"]]
    emit({"phase": phase, "counts": {"decode_attention": n5, "flash_attention": n6,
                                     "plain": 0},
          "tolerance": {k: {"atol": a, "rtol": r} for k, (a, r) in MODEL_TOL.items()},
          "tolerance_bf16_vs_f32": f"{BF16_F32_REL} x the largest |float32 plain output|",
          "cases": cases, "timed_bf16": timed_rows})
    if bad:
        raise AssertionError(f"{phase}: kernels disagree with plain: {bad}")
    return {"timed": timed_rows,
            "max_abs_err": {k: max(c["max_abs_err"] for c in cases if c["kernel"] == k)
                            for k in ("decode_attention", "flash_attention")}}


def phase_attention_widths(seed: int) -> dict:
    """K5 and K6 at the groups and head widths past their earlier
    ceilings (:func:`_attention_cases`): K5 at a group of 32 (and 64) and
    at hd 256, 96 and 33; K6 causal and not at hd 256, 96 and 72 (96 on
    the tensor cores in bf16, the rest on the any-width kernel), and at hd
    72 through the model's strided views; the bf16 causal cases timed."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 110)
    k5 = [("group 32", (4, 128, 4, 1024, 128)), ("group 64", (2, 64, 1, 1024, 64)),
          ("hd 256", (4, 16, 4, 1024, 256)), ("hd 96", (4, 16, 4, 1024, 96)),
          ("hd 33", (4, 16, 4, 1024, 33))]
    k6 = [(f"hd {w}{'' if c else ', not causal'}", (2, 16, 4, 1024, 1024, w), c)
          for w in WIDTH_K6 for c in (True, False)]
    views = [("hd 72, strided (B, S, H, hd) views", (2, 16, 4, 300, 72))]
    return _attention_cases("attention_widths", gen, k5, k6, views,
                            timed=lambda label: "not causal" not in label)


def phase_encdec_kernels(seed: int) -> dict:
    """K5 and K6 at Whisper-medium's shapes (:func:`_attention_cases`; 16
    query over 16 KV heads of 64, batch 4, 1500 frames): K6 not causal at
    S = T = 1500 (the encoder), S = 64 (a cross-attention prefill) and S =
    1 (cross-attention at decode: one row of a 128-row query tile, a tail
    of 92 keys), the encoder and S = 1 again on :func:`_ramp`'s inputs
    (the key mask's check), K6 at the decoder's causal self-attention
    through the model's strided views, and K5 at a group of 1 over 1024
    keys; every bf16 case on random inputs timed."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 140)
    cfg = get_config(ENCDEC_ARCH)
    b, h, hkv, hd, t = ENCDEC_BATCH, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_, cfg.encoder_seq
    k5 = [("whisper decode, group 1", (b, h, hkv, 1024, hd))]
    k6 = [("whisper encoder", (b, h, hkv, t, t, hd), False),
          ("whisper cross prefill", (b, h, hkv, ENCDEC_PROMPT, t, hd), False),
          ("whisper cross decode, S = 1", (b, h, hkv, 1, t, hd), False),
          ("whisper encoder, ramp", (b, h, hkv, t, t, hd), False, "ramp"),
          ("whisper cross decode, S = 1, ramp", (b, h, hkv, 1, t, hd), False, "ramp")]
    views = [("whisper decoder prefill, strided views", (b, h, hkv, ENCDEC_PROMPT, hd))]
    return _attention_cases("encdec_kernels", gen, k5, k6, views, timed=lambda label: True)


# ---- LLaVA-NeXT-Mistral-7B serving, and training on one card ------------------


def phase_vlm_serve(seed: int) -> dict:
    """LLaVA-NeXT-Mistral-7B at full width and depth: 4 sequences of 576
    seeded patch embeddings + 64 tokens prefilled (K6 on the tensor cores,
    K4), then 32 decode steps (K5 at a group of 4, K4); the last step's
    logits against one prefill of the extended sequence, within the dense
    serve phases' bf16 tolerance (PREFILL_REL_TOL, clear argmaxes
    agreeing); exact launch counts, no plain call."""
    cfg = get_config(VLM_ARCH)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(seed + 120)
    params = init_params(gen, cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    b, p_len, n = VLM_BATCH, cfg.n_patches, VLM_PROMPT
    patches = (torch.randn(b, p_len, cfg.d_model, generator=gen, device="cuda")
               * VLM_PATCH_STD).to(cfg.torch_dtype)
    toks = torch.randint(1, cfg.vocab, (b, n + VLM_STEPS), generator=gen, device="cuda",
                         dtype=torch.int32)
    _reset_model_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = prefill(params, cfg, {"tokens": toks[:, :n], "patches": patches},
                            max_len=p_len + n + VLM_STEPS)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    prefill_counts = _model_counts()
    _reset_model_counts()
    finite = [torch.isfinite(logits).all()]
    step_ms = []
    for i in range(VLM_STEPS):
        t0 = time.perf_counter()
        logits, cache = decode_step(params, cfg, toks[:, n + i : n + i + 1], cache)
        finite.append(torch.isfinite(logits).all())
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    decode_s = sum(step_ms) / 1e3
    decode_counts = _model_counts()
    pos = cache["pos"].tolist()
    del cache
    got = logits[:, 0].float()
    # the last decode step fed token n + 31 at position 576 + 64 + 31: the
    # prefill over tokens [0, n + 32) predicts the same next token
    want, _ = prefill(params, cfg, {"tokens": toks, "patches": patches})
    want = want[:, 0].float()
    peak = torch.cuda.max_memory_allocated()
    stats = _handoff_stats(got, want)
    del params
    torch.cuda.empty_cache()
    norms = 2 * cfg.n_layers + 1
    out = {
        "phase": "vlm_serve",
        "arch": VLM_ARCH,
        "layers": cfg.n_layers,
        "params": cfg.param_count(),
        "batch": b,
        "patches": p_len,
        "prompt_tokens": n,
        "decode_steps": VLM_STEPS,
        "init_s": init_s,
        "prefill_s": prefill_s,
        "prefill_tokens_per_s": b * (p_len + n) / prefill_s,
        "ms_per_decode_step": decode_s / VLM_STEPS * 1e3,
        "ms_per_decode_step_median": float(np.median(step_ms)),
        "ms_first_decode_steps": step_ms[:3],
        "peak_gb": peak / 1e9,
        "prefill_launches": prefill_counts,
        "decode_launches": decode_counts,
        "handoff": stats,
        "tolerance": PREFILL_REL_TOL,
    }
    emit(out)
    if pos != [p_len + n + VLM_STEPS] * b or not bool(torch.stack(finite).all()):
        raise AssertionError(f"vlm_serve: positions {pos} or non-finite logits")
    if stats["max_rel_err"] > PREFILL_REL_TOL or not stats["clear_argmax_agree"]:
        raise AssertionError(f"vlm_serve: decode disagrees with the extended prefill: {stats}")
    want_pre = {"rmsnorm": norms, "flash_attention": cfg.n_layers, "tensor_core": cfg.n_layers}
    want_dec = {"rmsnorm": VLM_STEPS * norms, "decode_attention": VLM_STEPS * cfg.n_layers}
    got_pre = {"rmsnorm": prefill_counts["rmsnorm"]["rmsnorm"],
               "flash_attention": prefill_counts["flash_attention"]["flash_attention"],
               "tensor_core": prefill_counts["flash_attention"]["tensor_core"]}
    got_dec = {"rmsnorm": decode_counts["rmsnorm"]["rmsnorm"],
               "decode_attention": decode_counts["decode_attention"]["decode_attention"]}
    plain = sum(c[k]["plain"] for c in (prefill_counts, decode_counts)
                for k in ("rmsnorm", "decode_attention", "flash_attention"))
    if got_pre != want_pre or got_dec != want_dec or plain:
        raise AssertionError(f"vlm_serve went around the kernels: prefill {got_pre} "
                             f"(want {want_pre}), decode {got_dec} (want {want_dec}), "
                             f"plain {plain}")
    merged = {k: {c: prefill_counts[k][c] + decode_counts[k][c] for c in prefill_counts[k]}
              for k in prefill_counts}
    return merged


@contextlib.contextmanager
def _plain_model_ops():
    """The model's kernel entries (``repro_torch.kernels.ops``) swapped for
    the plain versions, differentiated by autograd: the reference path of
    the train phases' gradient checks and of encdec_serve's float32 copy
    (this script's, never the port's)."""
    saved = (kops.rmsnorm_fused, kops.flash_attention, kops.ssd_scan, kops.decode_attention)
    kops.rmsnorm_fused = rnk.rmsnorm_plain
    kops.flash_attention = fak.flash_attention_plain
    kops.ssd_scan = lambda x, dt, a, bm, cm, *, chunk=ssk.CHUNK: ssk.ssd_scan_plain(
        x, dt, a, bm, cm, chunk)
    kops.decode_attention = dak.decode_attention_plain
    try:
        yield
    finally:
        kops.rmsnorm_fused, kops.flash_attention, kops.ssd_scan, kops.decode_attention = saved


def _step_grads(params, cfg, batch) -> tuple[float, dict]:
    """Loss and gradients (by parameter name) of one step's loss, no update."""
    names, leaves = zip(*params.named_parameters())
    for p in leaves:
        p.requires_grad_(True)
    loss, _ = train_loss_fn(params, cfg, batch, remat=False)
    grads = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), dict(zip(names, grads))


def _grad_distance(got: dict, want: dict) -> dict:
    """The global norms' relative difference, and relative L2 distances:
    of the whole gradient and of the worst leaf."""
    num = den = norm_got = 0.0
    worst, worst_name = 0.0, None
    for name, w in want.items():
        d = float((got[name].float() - w.float()).square().sum())
        n2 = float(w.float().square().sum())
        num, den = num + d, den + n2
        norm_got += float(got[name].float().square().sum())
        rel = (d / n2) ** 0.5 if n2 > 0 else (0.0 if d == 0 else float("inf"))
        if rel > worst:
            worst, worst_name = rel, name
    return {"global_norm": abs(norm_got**0.5 - den**0.5) / den**0.5, "whole": (num / den) ** 0.5,
            "leaf": worst, "worst_leaf_name": worst_name, "plain_global_norm": den**0.5}


def _grad_check(params, cfg, batch) -> tuple[dict, float, float]:
    """Step 1's gradients through the kernels' Functions against the plain
    path's: their distance and the two losses."""
    loss_k, g_k = _step_grads(params, cfg, batch)
    with _plain_model_ops():
        loss_p, g_p = _step_grads(params, cfg, batch)
    return _grad_distance(g_k, g_p), loss_k, loss_p


def _within(dist: dict, tol: dict) -> bool:
    return all(dist[k] <= v for k, v in tol.items())


def _loader_batch(cfg, b: int, s: int, seed: int) -> dict:
    """One (b, s + 1) batch from the locality-aware loader, its epoch's
    shard reads placed on the data hosts by water-filling on the card."""
    store = ShardStore(n_shards=64, n_hosts=16, replicas=3, tokens_per_shard=4096,
                       vocab=cfg.vocab, seed=seed)
    loader = LocalityAwareLoader(store, batch_tokens=b * (s + 1), seq_len=s + 1,
                                 assign=water_filling_torch, seed=seed, device="cuda")
    toks = next(iter(loader.batches(0)))
    return {"tokens": toks[:, :-1].contiguous(), "targets": toks[:, 1:].contiguous()}


def phase_train(seed: int) -> dict:
    """Training on one card, for each of TRAIN_MODELS: step 1's gradients
    through the kernels' Functions against the plain path's; 20 AdamW steps
    on one loader batch with exact launch counts and no plain call, the
    loss falling; the train state saved and restored through
    ``CheckpointManager`` (every leaf identical) and placed by
    ``register_checkpoint``."""
    out, counts_all = {}, []
    for arch, (layers, b, s) in TRAIN_MODELS.items():
        cfg = get_config(arch) if layers is None else get_config(arch).scaled(n_layers=layers)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        gen = torch.Generator(device="cuda").manual_seed(seed + 130)
        opt_cfg = TrainAdamWConfig(**TRAIN_OPT)
        state = train_state_init(gen, cfg, opt_cfg)
        n_params = sum(p.numel() for p in state.params.parameters())
        wl.reset_counts()
        batch = _loader_batch(cfg, b, s, seed)
        loader_counts = dict(wl.COUNTS)
        # step 1's gradients, kernel path then plain path: bf16, then float32
        _reset_model_counts()
        dist, loss_k, loss_p = _grad_check(state.params, cfg, batch)
        grad_counts = _model_counts()
        torch.cuda.empty_cache()
        params32 = copy.deepcopy(state.params).float()
        dist32, _, _ = _grad_check(params32, cfg, batch)
        del params32
        torch.cuda.empty_cache()
        # 20 steps
        step = make_train_step(cfg, opt_cfg, remat=False)
        st = state.as_dict()
        losses = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()  # the 20 steps' peak
        _reset_model_counts()
        t0 = time.perf_counter()
        for _ in range(TRAIN_STEPS):
            st, metrics = step(st, batch)
            losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        counts = _model_counts()
        counts_all.append(counts)
        peak = torch.cuda.max_memory_allocated()
        state = TrainState(st["params"], st["opt"])
        # the train state through the checkpoint store
        tree = state.tree()
        with tempfile.TemporaryDirectory() as tmp:
            ckpt_dir = Path(tmp) / arch
            mgr = CheckpointManager(str(ckpt_dir), keep=2)
            t0 = time.perf_counter()
            mgr.save_async(TRAIN_STEPS, tree)
            mgr.wait()
            save_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            restored_step, restored = mgr.restore_latest(tree)
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t0
            pairs = list(zip(ckpt_leaves(tree), ckpt_leaves(restored)))
            same = all(a.dtype == r.dtype and a.device == r.device and torch.equal(a, r)
                       for a, r in pairs)
            placed = PlacementStore(4)
            info = register_checkpoint(placed, str(ckpt_dir), servers=(0, 2))
            n_elems = sum(a.numel() for a, _ in pairs)
            ckpt = {"leaves": len(pairs), "elements": n_elems,
                    "bytes": sum(a.numel() * a.element_size() for a, _ in pairs),
                    "save_s": save_s, "restore_s": restore_s, "identical": same,
                    "step": restored_step, "block": info.block,
                    "replicas": list(placed.replicas(info.block)),
                    "manifest_leaves": info.n_leaves, "manifest_elements": info.n_params}
        del tree, restored, pairs, state, st
        torch.cuda.empty_cache()
        norms = 2 * cfg.n_layers + 1
        want = {"rmsnorm": norms}
        if cfg.block_pattern == "mamba2":
            want["ssd_scan"] = cfg.n_layers
        else:
            want["flash_attention"] = cfg.n_layers
        got = {k: counts[k][k] for k in want}
        plain = sum(counts[k]["plain"] for k in ("rmsnorm", "flash_attention", "ssd_scan"))
        got_grad = {k: grad_counts[k][k] for k in want}
        row = {
            "layers": f"{cfg.n_layers} of {get_config(arch).n_layers}",
            "batch": [b, s], "params": n_params,
            "loader_wf_launches": loader_counts,
            "loss_step1_kernel": loss_k, "loss_step1_plain": loss_p,
            "grad_distance": dist, "grad_tolerance": TRAIN_GRAD_TOL,
            "grad_distance_f32": dist32, "grad_tolerance_f32": TRAIN_GRAD_TOL_F32,
            "losses": losses, "ms_per_step": train_s / TRAIN_STEPS * 1e3,
            "tokens_per_s": TRAIN_STEPS * b * s / train_s, "peak_gb": peak / 1e9,
            "launches_per_step": {k: v / TRAIN_STEPS for k, v in got.items()},
            "checkpoint": ckpt,
        }
        out[arch] = row
        emit({"phase": "train", "arch": arch, **row})
        if not all(np.isfinite(losses)) or losses[-1] > losses[0] - TRAIN_LOSS_DROP:
            raise AssertionError(f"train {arch}: the loss did not fall by "
                                 f"{TRAIN_LOSS_DROP}: {losses}")
        if not (_within(dist, TRAIN_GRAD_TOL) and _within(dist32, TRAIN_GRAD_TOL_F32)):
            raise AssertionError(f"train {arch}: kernel-path gradients differ from the plain "
                                 f"path's: bf16 {dist}, float32 {dist32}")
        if got != {k: v * TRAIN_STEPS for k, v in want.items()} or got_grad != want or plain:
            raise AssertionError(f"train {arch} went around the kernels: {got} per "
                                 f"{TRAIN_STEPS} steps (want {want} a step), step 1 "
                                 f"{got_grad}, plain {plain}")
        if not (same and restored_step == TRAIN_STEPS and ckpt["replicas"] == [0, 2]
                and info.n_leaves == ckpt["leaves"] and info.n_params == n_elems):
            raise AssertionError(f"train {arch}: the checkpoint did not come back: {ckpt}")
    merged = {k: {c: sum(x[k][c] for x in counts_all) for c in counts_all[0][k]}
              for k in counts_all[0]}
    return {"rows": out, "counts": merged}


# ---- Whisper-medium (encoder-decoder): serving, training; the train driver --------


def _encdec_inputs(cfg, gen: torch.Generator, b: int, s: int) -> tuple:
    """Seeded N(0, 1) frame embeddings (b, encoder_seq, d) in the config's
    dtype (the stubbed conv frontend's output) and tokens (b, s)."""
    frames = torch.randn(b, cfg.encoder_seq, cfg.d_model, generator=gen,
                         device="cuda").to(cfg.torch_dtype)
    toks = torch.randint(1, cfg.vocab, (b, s), generator=gen, device="cuda",
                         dtype=torch.int32)
    return frames, toks


def _encdec_want(cfg, n_steps: int, tc: bool = True) -> tuple[dict, dict]:
    """K4 / K5 / K6 launches of Whisper's prefill and of ``n_steps`` decode
    steps: the encoder's 2L + 1 norms and L attentions, the decoder's 3L +
    1 norms and 2L attentions (self, cross) in the prefill; a decode step's
    3L + 1 norms, L K5 and L K6 (cross-attention at S = 1); ``tc``: every
    K6 launch on the tensor cores (bf16)."""
    enc, dec = cfg.n_encoder_layers, cfg.n_layers
    pre = {"rmsnorm": (2 * enc + 1) + (3 * dec + 1), "decode_attention": 0,
           "flash_attention": enc + 2 * dec}
    step = {"rmsnorm": n_steps * (3 * dec + 1), "decode_attention": n_steps * dec,
            "flash_attention": n_steps * dec}
    for want in (pre, step):
        want["tensor_core"] = want["flash_attention"] if tc else 0
    return pre, step


def _launches(counts: dict) -> dict:
    return {"rmsnorm": counts["rmsnorm"]["rmsnorm"],
            "decode_attention": counts["decode_attention"]["decode_attention"],
            "flash_attention": counts["flash_attention"]["flash_attention"],
            "tensor_core": counts["flash_attention"]["tensor_core"]}


def _launches_k4_k7(counts: dict) -> dict:
    """:func:`_launches` and K7's."""
    return {**_launches(counts), "ssd_scan": counts["ssd_scan"]["ssd_scan"]}


def _plain_calls(counts: dict) -> int:
    return sum(counts[k]["plain"] for k in ("rmsnorm", "decode_attention", "flash_attention",
                                            "ssd_scan"))


def _encdec_run(params, cfg, frames, toks, n_prompt: int, n_steps: int) -> dict:
    """Prefill ``toks[:, :n_prompt]`` after encoding ``frames``, then
    ``n_steps`` decode steps feeding the following tokens: the logits
    (B, 1 + n_steps, V), the walls, the launches of each part."""
    _reset_model_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = prefill(params, cfg, {"tokens": toks[:, :n_prompt], "frames": frames},
                            max_len=n_prompt + n_steps)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    pre = _model_counts()
    _reset_model_counts()
    out, step_ms = [logits], []
    for i in range(n_steps):
        t0 = time.perf_counter()
        logits, cache = decode_step(params, cfg, toks[:, n_prompt + i : n_prompt + i + 1], cache)
        out.append(logits)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    return {"logits": torch.cat(out, 1).float(), "prefill_s": prefill_s, "step_ms": step_ms,
            "prefill_counts": pre, "decode_counts": _model_counts(), "cache": cache}


def phase_encdec_serve(seed: int) -> dict:
    """Whisper-medium at full width and depth, bf16: the encoder over 4 x
    1500 seeded frame embeddings and a 64-token prompt prefilled (K4, K6
    on the tensor cores: 24 encoder, 24 self and 24 cross attentions),
    then 32 decode steps (K4, K5 at a group of 1, K6 at S = 1 for the
    cross-attention); the last step's logits against one prefill of the
    extended sequence (PREFILL_REL_TOL, clear argmaxes agreeing); exact
    launch counts, no plain call; one decode step profiled.  Then a float32
    copy at full width, 2 + 2 layers: prefill and 4 decode steps through
    the kernels against the same under the plain versions, within
    ENCDEC_F32_TOL."""
    cfg = get_config(ENCDEC_ARCH)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(seed + 150)
    params = init_params(gen, cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    b, n, steps, t = ENCDEC_BATCH, ENCDEC_PROMPT, ENCDEC_STEPS, cfg.encoder_seq
    frames, toks = _encdec_inputs(cfg, gen, b, n + steps)
    run = _encdec_run(params, cfg, frames, toks, n, steps)
    cache = run.pop("cache")
    pos = cache["pos"].tolist()
    # one decode step profiled at the last position (the step rewrites
    # the same cache row each time: its input cache keeps pos)
    fixed = dict(cache, pos=cache["pos"] - 1)
    tok = toks[:, -1:]

    def one_step():
        decode_step(params, cfg, tok, fixed)
        torch.cuda.synchronize()

    one_step()
    t0 = time.perf_counter()
    for _ in range(5):
        one_step()
    wall_ms = (time.perf_counter() - t0) / 5 * 1e3
    device = profile_device_us(one_step)
    device_ms = {k: v / 1e3 for k, v in device.items()}
    step_device_ms = sum(device_ms.values())
    del cache, fixed
    got = run["logits"][:, -1]
    # the last decode step fed token n + 31 at position n + 31: the prefill
    # over tokens [0, n + 32) predicts the same next token
    want, _ = prefill(params, cfg, {"tokens": toks, "frames": frames})
    stats = _handoff_stats(got, want[:, 0].float())
    peak = torch.cuda.max_memory_allocated()
    del params
    torch.cuda.empty_cache()
    # the float32 copy: kernels against plain, 2 + 2 layers at full width
    cfg32 = cfg.scaled(n_layers=ENCDEC_F32_LAYERS, n_encoder_layers=ENCDEC_F32_LAYERS,
                       dtype="float32")
    gen32 = torch.Generator(device="cuda").manual_seed(seed + 151)
    params32 = init_params(gen32, cfg32)
    frames32, toks32 = _encdec_inputs(cfg32, gen32, b, n + ENCDEC_F32_STEPS)
    run32 = _encdec_run(params32, cfg32, frames32, toks32, n, ENCDEC_F32_STEPS)
    with _plain_model_ops():
        plain32 = _encdec_run(params32, cfg32, frames32, toks32, n, ENCDEC_F32_STEPS)
    err32 = float((run32["logits"] - plain32["logits"]).abs().max())
    del params32, run32["cache"], plain32["cache"]
    torch.cuda.empty_cache()
    want_pre, want_dec = _encdec_want(cfg, steps)
    want_pre32, want_dec32 = _encdec_want(cfg32, ENCDEC_F32_STEPS, tc=False)
    got_pre, got_dec = _launches(run["prefill_counts"]), _launches(run["decode_counts"])
    got_pre32 = _launches(run32["prefill_counts"])
    got_dec32 = _launches(run32["decode_counts"])
    plain = _plain_calls(run["prefill_counts"]) + _plain_calls(run["decode_counts"])
    plain += _plain_calls(run32["prefill_counts"]) + _plain_calls(run32["decode_counts"])
    out = {
        "phase": "encdec_serve",
        "arch": ENCDEC_ARCH,
        "layers": {"encoder": cfg.n_encoder_layers, "decoder": cfg.n_layers},
        "params": n_params,
        "batch": b,
        "frames": t,
        "prompt_tokens": n,
        "decode_steps": steps,
        "init_s": init_s,
        "prefill_s": run["prefill_s"],
        "prefill_positions_per_s": b * (t + n) / run["prefill_s"],
        "prefill_tokens_per_s": b * n / run["prefill_s"],
        "ms_per_decode_step": sum(run["step_ms"]) / steps,
        "ms_per_decode_step_median": float(np.median(run["step_ms"])),
        "ms_first_decode_steps": run["step_ms"][:3],
        "decode_tokens_per_s": b * steps / (sum(run["step_ms"]) / 1e3),
        "step_wall_ms": wall_ms,
        "step_device_ms": step_device_ms,
        "device_busy_share": step_device_ms / wall_ms if step_device_ms else None,
        "step_device_ms_by_kernel": dict(sorted(device_ms.items(), key=lambda kv: -kv[1])[:10]),
        "peak_gb": peak / 1e9,
        "prefill_launches": got_pre,
        "decode_launches": got_dec,
        "plain_calls": plain,
        "handoff": stats,
        "tolerance": PREFILL_REL_TOL,
        "float32_copy": {"layers": f"{ENCDEC_F32_LAYERS} + {ENCDEC_F32_LAYERS}",
                         "decode_steps": ENCDEC_F32_STEPS, "max_abs_logit_err": err32,
                         "max_abs_logit": float(plain32["logits"].abs().max()),
                         "tolerance": ENCDEC_F32_TOL, "prefill_launches": got_pre32,
                         "decode_launches": got_dec32,
                         "plain_path_plain_calls": _plain_calls(plain32["prefill_counts"])
                         + _plain_calls(plain32["decode_counts"])},
    }
    emit(out)
    if pos != [n + steps] * b or not bool(torch.isfinite(run["logits"]).all()):
        raise AssertionError(f"encdec_serve: positions {pos} or non-finite logits")
    if stats["max_rel_err"] > PREFILL_REL_TOL or not stats["clear_argmax_agree"]:
        raise AssertionError(f"encdec_serve: decode disagrees with the extended prefill: "
                             f"{stats}")
    if err32 > ENCDEC_F32_TOL:
        raise AssertionError(f"encdec_serve: float32 kernels differ from plain by {err32}")
    if (got_pre != want_pre or got_dec != want_dec or got_pre32 != want_pre32
            or got_dec32 != want_dec32 or plain):
        raise AssertionError(f"encdec_serve went around the kernels: prefill {got_pre} "
                             f"(want {want_pre}), decode {got_dec} (want {want_dec}), "
                             f"float32 {got_pre32} / {got_dec32} (want {want_pre32} / "
                             f"{want_dec32}), plain {plain}")
    return {k: {c: run["prefill_counts"][k][c] + run["decode_counts"][k][c]
                for c in run["prefill_counts"][k]} for k in run["prefill_counts"]}


def phase_encdec_train(seed: int) -> dict:
    """Whisper-medium training at full width and depth, bf16, AdamW with
    bf16 moments: 4 x (1500 seeded frames + 448 tokens from the
    locality-aware loader); step 1's gradients through the kernels'
    Functions against the plain path's on the first ENCDEC_GRAD_BATCH
    sequences (bf16 within TRAIN_GRAD_TOL, a
    float32 copy within TRAIN_GRAD_TOL_F32; the memory's gradient sums
    over the 24 decoder layers' cross-attentions into the encoder);
    ENCDEC_TRAIN_STEPS steps with the loss falling by TRAIN_LOSS_DROP and
    exact K4 / K6
    launches a step (the encoder's layers recomputed in the backward, as
    the reference's ``jax.checkpoint``), no plain call."""
    cfg = get_config(ENCDEC_ARCH)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(seed + 160)
    opt_cfg = TrainAdamWConfig(**TRAIN_OPT)
    state = train_state_init(gen, cfg, opt_cfg)
    n_params = sum(p.numel() for p in state.params.parameters())
    b, s = ENCDEC_BATCH, ENCDEC_TRAIN_TOKENS
    batch = _loader_batch(cfg, b, s, seed)
    batch["frames"], _ = _encdec_inputs(cfg, gen, b, 1)
    # step 1's gradients on the first ENCDEC_GRAD_BATCH sequences (the
    # check's four passes are this phase's second cost after the steps)
    check = {k: v[:ENCDEC_GRAD_BATCH] for k, v in batch.items()}
    _reset_model_counts()
    dist, loss_k, loss_p = _grad_check(state.params, cfg, check)
    grad_counts = _model_counts()
    torch.cuda.empty_cache()
    params32 = copy.deepcopy(state.params).float()
    dist32, _, _ = _grad_check(params32, cfg, check)  # the encoder upcasts the frames
    del params32, check
    torch.cuda.empty_cache()
    step = make_train_step(cfg, opt_cfg, remat=False)
    st = state.as_dict()
    losses = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_model_counts()
    t0 = time.perf_counter()
    for _ in range(ENCDEC_TRAIN_STEPS):
        st, metrics = step(st, batch)
        losses.append(float(metrics["loss"]))
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    counts = _model_counts()
    peak = torch.cuda.max_memory_allocated()
    del st, state
    torch.cuda.empty_cache()
    enc, dec = cfg.n_encoder_layers, cfg.n_layers
    # forward: (2 enc + 1) + (3 dec + 1) norms, enc + 2 dec attentions; the
    # backward recomputes each encoder layer's 2 norms and its attention
    want = {"rmsnorm": (2 * enc + 1) + (3 * dec + 1) + 2 * enc,
            "flash_attention": enc + 2 * dec + enc}
    want["tensor_core"] = want["flash_attention"]
    got = {k: v for k, v in _launches(counts).items() if k in want}
    got_grad = {k: v for k, v in _launches(grad_counts).items() if k in want}
    plain = _plain_calls(counts)  # grad_counts hold the plain path's own calls
    row = {
        "phase": "encdec_train", "arch": ENCDEC_ARCH,
        "layers": {"encoder": enc, "decoder": dec},
        "batch": {"sequences": b, "frames": cfg.encoder_seq, "tokens": s},
        "params": n_params,
        "grad_check_batch": f"{ENCDEC_GRAD_BATCH} of the {b} sequences (the check alone)",
        "loss_step1_kernel": loss_k, "loss_step1_plain": loss_p,
        "grad_distance": dist, "grad_tolerance": TRAIN_GRAD_TOL,
        "grad_distance_f32": dist32, "grad_tolerance_f32": TRAIN_GRAD_TOL_F32,
        "losses": losses, "ms_per_step": train_s / ENCDEC_TRAIN_STEPS * 1e3,
        "tokens_per_s": ENCDEC_TRAIN_STEPS * b * s / train_s,
        "frames_per_s": ENCDEC_TRAIN_STEPS * b * cfg.encoder_seq / train_s,
        "peak_gb": peak / 1e9,
        "launches_per_step": {k: v / ENCDEC_TRAIN_STEPS for k, v in got.items()},
        "plain_calls": plain,
    }
    emit(row)
    if not all(np.isfinite(losses)) or losses[-1] > losses[0] - TRAIN_LOSS_DROP:
        raise AssertionError(f"encdec_train: the loss did not fall by {TRAIN_LOSS_DROP}: "
                             f"{losses}")
    if not (_within(dist, TRAIN_GRAD_TOL) and _within(dist32, TRAIN_GRAD_TOL_F32)):
        raise AssertionError(f"encdec_train: kernel-path gradients differ from the plain "
                             f"path's: bf16 {dist}, float32 {dist32}")
    per_run = {k: v * ENCDEC_TRAIN_STEPS for k, v in want.items()}
    if got != per_run or got_grad != want or plain:
        raise AssertionError(f"encdec_train went around the kernels: {got} per "
                             f"{ENCDEC_TRAIN_STEPS} steps (want {want} a step), step 1 "
                             f"{got_grad}, plain {plain}")
    return counts


def phase_launch_train(seed: int) -> dict:
    """The port's train driver, ``repro_torch.launch.train.main``, on the
    card: Mamba2-130M whole, LAUNCH_STEPS[0] steps into a temporary
    ``--ckpt-dir`` (its async save at step 50, the final save at the end),
    then again to LAUNCH_STEPS[1], which must resume from the first run's
    last step.  The driver keeps the reference's ``remat=True``: a step
    launches K4 and K7 for the forward and again for each layer's
    recomputation; its loader keeps the host ``water_filling`` (no WF
    kernel); no plain call."""
    from repro_torch.launch import train as launch_train

    cfg = get_config(LAUNCH_ARCH)
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        done = 0
        for n in LAUNCH_STEPS:
            _reset_model_counts()
            out = io.StringIO()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                launch_train.main(["--arch", LAUNCH_ARCH, "--steps", str(n),
                                   "--ckpt-dir", tmp])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = _model_counts()
            lines = out.getvalue().splitlines()
            runs.append({"steps": n, "ran": n - done, "wall_s": wall, "output": lines,
                         "counts": counts,
                         "checkpoints": sorted(p.name for p in Path(tmp).iterdir())})
            done = n
    # per step: the forward's 2L + 1 norms and L scans, and the backward's
    # recomputation of every layer (its 2 norms and its scan)
    per_step = {"rmsnorm": 2 * cfg.n_layers + 1 + 2 * cfg.n_layers,
                "ssd_scan": 2 * cfg.n_layers}
    emit({"phase": "launch_train", "arch": LAUNCH_ARCH, "layers": cfg.n_layers,
          "flags": "--steps N --ckpt-dir TMP (seq-len 128, batch 8: the driver's defaults)",
          "runs": [{k: v for k, v in r.items() if k != "counts"} for r in runs],
          "launches_per_step": [{k: r["counts"][k][k] / r["ran"] for k in per_step}
                                for r in runs],
          "want_per_step": per_step,
          "steps": f"{LAUNCH_STEPS[0]}, then {LAUNCH_STEPS[1]}: the async save at 50, the "
                   "final save, resumed steps"})
    first, second = runs
    resumed = f"resumed from step {LAUNCH_STEPS[0]}"
    want_ckpt = [[f"step_{s:08d}" for s in (50, LAUNCH_STEPS[0])],
                 [f"step_{s:08d}" for s in (50, *LAUNCH_STEPS)]]
    if (any(resumed in line for line in first["output"])
            or resumed not in second["output"][0]
            or [r["checkpoints"] for r in runs] != want_ckpt
            or first["output"][-1] != f"finished at step {LAUNCH_STEPS[0]}"
            or second["output"][-1] != f"finished at step {LAUNCH_STEPS[1]}"):
        raise AssertionError(f"launch_train: the driver did not save and resume as asked: "
                             f"{[(r['output'], r['checkpoints']) for r in runs]}")
    for r in runs:
        got = {k: r["counts"][k][k] for k in per_step}
        want = {k: v * r["ran"] for k, v in per_step.items()}
        plain = _plain_calls(r["counts"])
        wf = r["counts"]["waterlevel"]
        if got != want or plain or any(wf[k] for k in wf if k != "plain"):
            raise AssertionError(f"launch_train went around the kernels: {got} in "
                                 f"{r['ran']} steps (want {want}), plain {plain}, WF {wf}")
    return {k: {c: sum(r["counts"][k][c] for r in runs) for c in runs[0]["counts"][k]}
            for k in runs[0]["counts"]}


# ---- the parallel/ slice: a world of one NCCL rank -----------------------------


@contextlib.contextmanager
def one_rank_world():
    """An NCCL process group of one rank on ``cuda:0`` (rendezvous through a
    ``FileStore`` in a temporary directory) and its (1, 1) (data, model)
    mesh; the group is destroyed however the block ends."""
    with tempfile.TemporaryDirectory() as tmp:
        store = dist.FileStore(os.path.join(tmp, "store"), 1)
        dist.init_process_group("nccl", store=store, rank=0, world_size=1,
                                timeout=datetime.timedelta(seconds=NCCL_TIMEOUT_S))
        try:
            dist.all_reduce(torch.ones(1, device="cuda"))  # NCCL's start, outside the timings
            yield make_mesh((1, 1), ("data", "model"), "cuda")
        finally:
            dist.destroy_process_group()


def _max_diff(a: dict, b: dict) -> float:
    """The largest |a - b| over two dicts of tensors with the same keys."""
    return max(float((a[k].float() - v.float()).abs().max()) for k, v in b.items())


def _tree_paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _tree_paths(v, prefix + (k,))
    else:
        yield prefix, tree


def _parallel_run(cfg, opt_cfg, state: TrainState, batch: dict, mesh, steps: int,
                  remat: bool = False) -> dict:
    """``steps`` sharded steps and ``steps`` single-device steps from the
    same state: each side's losses, final parameters, per-step K4/K6
    launches, plain calls, wall and the sharded side's peak memory."""
    out = {"sharded": shard_train_state(mesh, state)}
    for side in ("sharded", "single"):
        step = make_train_step(cfg, opt_cfg, remat=remat,
                               mesh=mesh if side == "sharded" else None)
        st = out.pop(side) if side == "sharded" else state.as_dict()
        losses, walls = [], []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        _reset_model_counts()
        with set_mesh(mesh) if side == "sharded" else contextlib.nullcontext():
            for _ in range(steps):
                t0 = time.perf_counter()
                st, metrics = step(st, batch)
                losses.append(float(metrics["loss"]))  # a host sync
                walls.append(time.perf_counter() - t0)
        counts = _model_counts()
        if side == "sharded":
            params = dict(_tree_paths(gather_state(st)["params"]))
        else:  # keyed like the sharded tree; copies: the caller reuses the model
            params = {tuple(n.split(".")): p.detach().clone()
                      for n, p in st["params"].named_parameters()}
        out[side] = {"losses": losses, "params": params, "walls_s": walls,
                     "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                     "step_gb": (torch.cuda.max_memory_allocated() - held) / 1e9,
                     "k4": counts["rmsnorm"]["rmsnorm"], "k6": counts["flash_attention"][
                         "flash_attention"], "plain": _plain_calls(counts), "counts": counts}
        del st
    return out


def phase_parallel_train(seed: int, mesh, card: str) -> dict:
    """The sharded train step (``make_train_step(..., mesh=)``) on the card
    in a world of one rank: Qwen1.5-4B at full width, PARALLEL_MODEL's
    depth and batch (phase_train's cut), bf16 with bf16 moments, 3 sharded
    and 3 single-device steps from one seeded state on one loader batch;
    the losses and every parameter within the reference test's limits,
    then a float32 copy's first step held the same way; K4 and K6 launched
    as often a step as by the single-device step, no plain call."""
    layers, b, s = PARALLEL_MODEL
    cfg = get_config(PARALLEL_ARCH).scaled(n_layers=layers)
    opt_cfg = TrainAdamWConfig(**TRAIN_OPT)
    gen = torch.Generator(device="cuda").manual_seed(seed + 170)
    state = train_state_init(gen, cfg, opt_cfg)
    batch = _loader_batch(cfg, b, s, seed)
    snapshot = {n: p.detach().clone() for n, p in state.params.named_parameters()}
    runs = {"bfloat16": _parallel_run(cfg, opt_cfg, state, batch, mesh, PARALLEL_STEPS)}
    torch.cuda.empty_cache()
    with torch.no_grad():  # the float32 copy starts from the same weights
        for n, p in state.params.named_parameters():
            p.copy_(snapshot[n])
    del snapshot
    params32 = state.params.float()
    state32 = TrainState(params32, adamw_init(opt_cfg, params32))
    runs["float32"] = _parallel_run(cfg, opt_cfg, state32, batch, mesh, 1)
    del state, state32, params32
    torch.cuda.empty_cache()
    rows, ok = {}, True
    per_step = {"rmsnorm": 2 * cfg.n_layers + 1, "flash_attention": cfg.n_layers}
    for dtype, r in runs.items():
        sh, si = r["sharded"], r["single"]
        n = len(sh["losses"])
        loss_d = max(abs(a - c) for a, c in zip(sh["losses"], si["losses"]))
        param_d = _max_diff(sh["params"], si["params"])
        launches = {"sharded": {"rmsnorm": sh["k4"] / n, "flash_attention": sh["k6"] / n},
                    "single": {"rmsnorm": si["k4"] / n, "flash_attention": si["k6"] / n}}
        rows[dtype] = {"steps": n, "losses_sharded": sh["losses"], "losses_single": si["losses"],
                       "loss_distance": loss_d, "param_distance": param_d,
                       "step_ms_sharded": [w * 1e3 for w in sh["walls_s"]],
                       "step_ms_single": [w * 1e3 for w in si["walls_s"]],
                       "peak_gb_sharded": sh["peak_gb"], "peak_gb_single": si["peak_gb"],
                       "step_gb_sharded": sh["step_gb"], "step_gb_single": si["step_gb"],
                       "launches_per_step": launches, "plain_calls": sh["plain"] + si["plain"]}
        ok &= (loss_d <= PARALLEL_TOL["loss"] and param_d <= PARALLEL_TOL["params"]
               and launches["sharded"] == launches["single"] == per_step
               and sh["plain"] == si["plain"] == 0)
    emit({"phase": "parallel_train", "arch": PARALLEL_ARCH, "card": card,
          "mesh": {"data": 1, "model": 1}, "world": "one NCCL rank on cuda:0",
          "reduced": {"depth": f"{cfg.n_layers} of {get_config(PARALLEL_ARCH).n_layers} "
                      "layers", "batch": [b, s], "steps": PARALLEL_STEPS},
          "tolerance": PARALLEL_TOL, "want_launches_per_step": per_step, "runs": rows})
    if not ok:
        raise AssertionError(f"parallel_train: the sharded step differs from the single-device "
                             f"step or went around the kernels: {rows}")
    counts = runs["bfloat16"]["sharded"]["counts"]
    return {k: {c: sum(r[side]["counts"][k][c] for r in runs.values()
                       for side in ("sharded", "single")) for c in counts[k]} for k in counts}


def phase_moe_sharded(seed: int, mesh, card: str) -> dict:
    """The expert-parallel MoE (``moe_apply_sharded``) of one
    Qwen3-MoE-235B-A22B layer at full width (128 experts, top 8, experts
    of width 1536) on 4 x 1024 bf16 tokens at capacity factor 1.25,
    under ``dispatch="shard_map"`` on the (1, 1) mesh: the kept set
    identical to ``moe_apply``'s (local capacity = global capacity on
    one data shard), y and aux within MODEL_TOL; both timed."""
    base = get_config(MOE_SHARDED_ARCH)
    cfg = dataclasses.replace(base, n_layers=1, moe=dataclasses.replace(
        base.moe, dispatch="shard_map", capacity_factor=MOE_SHARDED_CF))
    gen = torch.Generator(device="cuda").manual_seed(seed + 180)
    p = moe_ffn.MoE(cfg, device="cuda")
    moe_ffn.moe_init_(p, gen)
    b, s = MOE_SHARDED_TOKENS
    # tokens sharing a common direction, as a layer's activations do: the
    # router favours some experts, and some assignments overflow
    x = (_randn(gen, (b, s, cfg.d_model), torch.float32)
         + _randn(gen, (1, 1, cfg.d_model), torch.float32)).to(cfg.torch_dtype)
    with torch.no_grad(), set_mesh(mesh):
        y_s, aux_s = moe_apply_sharded(p, cfg, x, mesh)
        keep_s = moe_route_sharded(p, cfg, x, mesh)["keep"]
        y_r, aux_r = moe_ffn.moe_apply(p, cfg, x)
        keep_r = moe_ffn.moe_route(p, cfg, x)["keep"]
        ms_s = cuda_ms(lambda: moe_apply_sharded(p, cfg, x, mesh), 5)
        ms_r = cuda_ms(lambda: moe_ffn.moe_apply(p, cfg, x), 5)
    same_keep = bool(torch.equal(keep_s, keep_r))
    y_err, y_ok = _model_err(y_s, y_r, "bfloat16")
    aux_err, aux_ok = _model_err(aux_s, aux_r, "bfloat16")
    row = {"arch": MOE_SHARDED_ARCH, "card": card,
           "reduced": {"depth": f"one layer's FFN of {base.n_layers}"},
           "experts": cfg.moe.n_experts,
           "top_k": cfg.moe.top_k, "d_ff_expert": cfg.moe.d_ff_expert, "tokens": [b, s],
           "capacity_factor": MOE_SHARDED_CF, "kept": int(keep_s.sum()),
           "assignments": keep_s.numel(), "kept_set_identical": same_keep,
           "dropped_share": 1 - int(keep_s.sum()) / keep_s.numel(),
           "y_max_abs_err": y_err, "aux": [float(aux_s), float(aux_r)], "aux_abs_err": aux_err,
           "tolerance": MODEL_TOL["bfloat16"], "finite": bool(torch.isfinite(y_s).all()),
           "ms_sharded": ms_s, "ms_moe_apply": ms_r}
    del p, x, y_s, y_r
    torch.cuda.empty_cache()
    emit({"phase": "moe_sharded", **row})
    if not (same_keep and y_ok and aux_ok and row["finite"]):
        raise AssertionError(f"moe_sharded differs from moe_apply: {row}")
    return row


def phase_compress(seed: int, mesh, card: str) -> dict:
    """int8 gradient compression with error feedback on the card: the
    reference test's regression (64 x 16, one data shard): one step's
    relative error below 0.02, and after 300 steps of descent within 0.05
    of the target."""
    rng = np.random.default_rng(seed + 190)
    xs_np = rng.normal(size=(64, 16)).astype(np.float32)
    xs = torch.from_numpy(xs_np).cuda()
    ys = torch.from_numpy(xs_np @ np.arange(16, dtype=np.float32)).cuda()

    def grad_fn(w, batch):
        x, y = batch
        w = w.detach().requires_grad_(True)
        return torch.autograd.grad(((x @ w - y) ** 2).mean(), w)[0]

    w = torch.zeros(16, device="cuda")
    exact = grad_fn(w, (xs, ys))
    fn = make_compressed_grad_fn(grad_fn, mesh)
    err = init_error_state(w)
    g, err = fn(w, (xs, ys), err)
    rel = float((g - exact).abs().max() / exact.abs().max())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(COMPRESS_STEPS):
        g, err = fn(w, (xs, ys), err)
        w = w - 0.1 * g
    final = float((w - torch.arange(16.0, device="cuda")).abs().max())
    wall = time.perf_counter() - t0
    row = {"card": card, "one_step_rel_err": rel, "steps": COMPRESS_STEPS,
           "final_max_abs_err": final, "limits": {"one_step": 0.02, "final": 0.05},
           "ms_per_step": wall / COMPRESS_STEPS * 1e3, "residual_shape": list(err.shape)}
    emit({"phase": "compress", **row})
    if not (rel < 0.02 and final < 0.05):
        raise AssertionError(f"compress: {row}")
    return row


def slice13_phases(seed: int, card: str) -> dict:
    """The parallel/ slice's three phases in one world of one NCCL rank;
    their walls on the ``slice13_phases`` line; returns the sharded
    train phase's launch counts."""
    seconds = {}
    with one_rank_world() as mesh:
        t0 = time.perf_counter()
        counts = phase_parallel_train(seed, mesh, card)
        seconds["parallel_train"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        phase_moe_sharded(seed, mesh, card)
        seconds["moe_sharded"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        phase_compress(seed, mesh, card)
        seconds["compress"] = time.perf_counter() - t0
    emit({"phase": "slice13_phases", "seconds": seconds, "total_s": sum(seconds.values()),
          "budget_s": SLICE13_BUDGET_S, "card": card})
    return counts


# ---- slice 14: the dry run's counts against real steps -----------------------


# the kernels each (family, step kind) must launch on the card: Mamba2's
# decode step is a plain recurrence (no K5, no K7)
DRYRUN_KERNELS = {("dense", "train"): ("rmsnorm", "flash_attention"),
                  ("dense", "prefill"): ("rmsnorm", "flash_attention"),
                  ("dense", "decode"): ("rmsnorm", "decode_attention"),
                  ("mamba2", "train"): ("rmsnorm", "ssd_scan"),
                  ("mamba2", "prefill"): ("rmsnorm", "ssd_scan"),
                  ("mamba2", "decode"): ("rmsnorm",)}


def _fill_step_args(kind: str, args: tuple, gen: torch.Generator, vocab: int) -> None:
    """Seeded values in a real step's arguments: the parameters N(0, 0.02²),
    the tokens and targets uniform over the vocabulary; the moments and
    the cache stay zero (``pos`` at the cache's end)."""
    params = args[0]["params"] if kind == "train" else args[0]
    batch = args[1] if kind != "decode" else {"tokens": args[1]}
    with torch.no_grad():
        for t in dry._tensors(params):
            t.copy_(_randn(gen, t.shape, torch.float32).mul_(0.02).to(t.dtype))
        for t in dry._tensors(batch):
            if not t.is_floating_point():
                t.copy_(torch.randint(0, vocab, t.shape, generator=gen, device="cuda"))


def _dryrun_shapes() -> list[ShapeSpec]:
    b, s = DRYRUN_BATCH
    return [ShapeSpec(f"check_{kind}", kind, s, b) for kind in ("train", "prefill", "decode")]


def phase_dryrun_check(seed: int, card: str) -> dict:
    """The dry run's counts against real steps: for Qwen1.5-4B and
    Mamba2-130M at full width and 2 layers, a train step, a prefill and a
    decode step (DRYRUN_BATCH) through ``step_fn_for`` on a (1, 1) mesh,
    counted on ``meta`` in a fake world of one rank
    (``dryrun.count_step``) and run for real in a world of one NCCL rank,
    counted the same way: (a) the meta FLOP count equals the CUDA step's
    exactly; (b) the kernels of the step launched on the card, as many
    times as the meta count's calls; (c) meta ``peak_bytes`` within
    DRYRUN_PEAK_TOL of ``torch.cuda.max_memory_allocated`` over the step;
    (d) each step's time (median of DRYRUN_TIMED) beside its bound under
    the H100's data-sheet peaks (printed, not checked); (e) ``hbm_bytes``
    equals the card's ``total_memory``."""
    opt_cfg = TrainAdamWConfig()
    cases = [(arch, get_config(arch).scaled(n_layers=layers), shape)
             for arch, layers in DRYRUN_ARCHS.items() for shape in _dryrun_shapes()]
    meta = {}
    with dry.fake_world(1):
        mesh = make_mesh((1, 1), ("data", "model"), "cpu")
        for arch, cfg, shape in cases:
            fn, args = step_fn_for(cfg, shape, opt_cfg, mesh=mesh,
                                   in_shardings=dry.shardings_for(mesh, cfg, shape, opt_cfg))
            out, meta[arch, shape.kind] = dry.count_step(fn, args)
            del fn, args, out
    rows, ok = [], True
    gen = torch.Generator(device="cuda").manual_seed(seed + 270)
    with one_rank_world() as mesh:
        for arch, cfg, shape in cases:
            m = meta[arch, shape.kind]
            _free()
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            fn, args = step_fn_for(cfg, shape, opt_cfg, mesh=mesh, device="cuda",
                                   in_shardings=dry.shardings_for(mesh, cfg, shape, opt_cfg))
            _fill_step_args(shape.kind, args, gen, cfg.vocab)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _reset_model_counts()
            out, c = dry.count_step(fn, args, device="cuda")
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
            launches = {k: v[k] for k, v in _model_counts().items() if k != "waterlevel"}
            del out
            walls = []
            for _ in range(DRYRUN_TIMED):
                t0 = time.perf_counter()
                out = fn(*args)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                del out
            del fn, args
            want = DRYRUN_KERNELS[cfg.block_pattern, shape.kind]
            bound_s = max(m.flops / roof.PEAK_FLOPS, m.bytes / roof.HBM_BW)
            ms = sorted(walls)[len(walls) // 2] * 1e3
            row = {"arch": arch, "layers": cfg.n_layers, "kind": shape.kind,
                   "batch": list(DRYRUN_BATCH), "flops_meta": m.flops, "flops_cuda": c.flops,
                   "kernel_calls_meta": {k: v["calls"] for k, v in m.kernels.items()},
                   "launches_cuda": launches, "bytes_meta": m.bytes, "bytes_cuda": c.bytes,
                   "peak_bytes_meta": m.peak_bytes, "peak_bytes_cuda": peak,
                   "peak_ratio": m.peak_bytes / peak, "temp_bytes_meta": m.temp_bytes,
                   "temp_bytes_cuda_tracker": c.temp_bytes,
                   "ms": ms, "bound_ms": bound_s * 1e3, "ms_over_bound": ms / (bound_s * 1e3)}
            row["checks"] = {
                "a_flops_equal": m.flops == c.flops,
                "b_kernels_launched": all(launches[k] > 0 for k in want)
                and all(launches[k] == m.kernels.get(k, {"calls": 0})["calls"]
                        for k in launches),
                "c_peak_within_tol": abs(m.peak_bytes / peak - 1) <= DRYRUN_PEAK_TOL,
            }
            ok &= all(row["checks"].values())
            rows.append(row)
    total = torch.cuda.get_device_properties(0).total_memory
    hbm_ok = dry.HBM_BYTES == total
    emit({"phase": "dryrun_check", "card": card, "world": "meta: fake world of one rank; "
          "cuda: one NCCL rank on cuda:0; (1, 1) (data, model) mesh", "peak_tol": DRYRUN_PEAK_TOL,
          "hbm_bytes": dry.HBM_BYTES, "total_memory": total, "e_hbm_equal": hbm_ok,
          "bound": "max(flops / 989e12, bytes / 3.35e12): H100 SXM5 data-sheet peaks",
          "rows": rows})
    if not (ok and hbm_ok):
        raise AssertionError(f"dryrun_check failed: hbm {dry.HBM_BYTES} vs {total}; {rows}")
    return {"rows": rows}


def slice14_phases(seed: int, card: str) -> None:
    """The dry run's check; its wall on the ``slice14_phases`` line."""
    t0 = time.perf_counter()
    phase_dryrun_check(seed, card)
    seconds = {"dryrun_check": time.perf_counter() - t0}
    emit({"phase": "slice14_phases", "seconds": seconds, "total_s": sum(seconds.values()),
          "budget_s": SLICE14_BUDGET_S, "card": card})


# ---- slice 15: the reference's example entry points --------------------------


def _example(name: str) -> dict:
    """``examples_torch/<name>.py``'s globals, loaded by path."""
    return runpy.run_path(str(ROOT / "examples_torch" / f"{name}.py"))


def _run_example(name: str, argv: list[str], dev: str, **inject) -> tuple[list[str], float]:
    """``examples_torch/<name>.py``'s ``main(argv + --device dev, **inject)``:
    its printed lines and its wall (the card's work synchronised)."""
    main = _example(name)["main"]
    out = io.StringIO()
    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        main([*argv, "--device", dev], **inject)
    sync()
    return out.getvalue().splitlines(), time.perf_counter() - t0


def _example_cpu_params(name: str):
    """The weights, drawn once on the CPU from a seed, of an example that
    takes them on both sides (serving, training), else None."""
    if name == "serve_moe_balanced":
        cfg = get_smoke_config("qwen1.5-4b")
    elif name == "train_locality":
        cfg = _example("train_locality")["model_config"]("mamba2-130m")
    else:
        return None
    with set_backend(device="cpu"):
        return init_params(torch.Generator().manual_seed(0), cfg)


def _example_side(name: str, dev: str, cpu_params, ckpt: str | None) -> tuple[list, list]:
    """One example's calls (EXAMPLE_CALLS) on ``dev``: its printed lines
    (the checkpoint folder written ``CKPT``) and each call's seconds; the
    training example's calls in a checkpoint folder of the side's own
    under ``ckpt``."""
    lines, seconds = [], []
    folder = os.path.join(ckpt, dev) if ckpt is not None else None
    for argv in EXAMPLE_CALLS.get(name, ([],)):
        if folder is not None:
            argv = [*argv, "--ckpt-dir", folder]
        inject = {}
        if cpu_params is not None:
            inject["params"] = (cpu_params if dev == "cpu"
                                else copy.deepcopy(cpu_params).to(dev))
        out, wall = _run_example(name, argv, dev, **inject)
        lines += [line.replace(folder, "CKPT") if folder else line for line in out]
        seconds.append(wall)
    return lines, seconds


def examples_cpu_half() -> dict:
    """The four examples' CPU side (``--device cpu``), run in the host
    worker beside the card's phases on EXAMPLE_CPU_THREADS threads: each
    one's printed lines and seconds, and the whole side's wall."""
    torch.set_num_threads(EXAMPLE_CPU_THREADS)
    t0 = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name in EXAMPLES:
            out[name] = _example_side(name, "cpu", _example_cpu_params(name),
                                      tmp if name == "train_locality" else None)
    return {"examples": out, "wall_s": time.perf_counter() - t0}


def _example_launches() -> dict:
    """The launches since the last reset, by kernel, the ``wf_torch``
    adapter calls, and the plain calls and host RD re-runs."""
    counts = _model_counts()
    wf = counts.pop("waterlevel")
    return {"wf_fused": _fused_launches(wf), "wf_adapter_calls": wf_torch.CALLS["adapter"],
            "waterlevel": wf["waterlevel"] + wf["waterlevel_batch"],
            "rd_step": rdk.COUNTS["rd_step"], **{k: c[k] for k, c in counts.items()},
            "flash_attention_tensor_core": counts["flash_attention"]["tensor_core"],
            "plain": wf["plain"] + rdk.COUNTS["plain"] + rdk.COUNTS["wide"]
            + _plain_calls(counts),
            "rd_host_reruns": rd_torch.COUNTS["host_reruns"]}


def _example_steps(lines: list[str]) -> list[tuple[int, int]]:
    """(step, loss in units of its last printed digit, 1e-4) of each step
    the training example printed."""
    return [(int(line.split()[1]), round(float(line.split()[2].split("=")[1]) * 1e4))
            for line in lines if line.startswith("step ")]


def phase_examples(card: str, cpu_half) -> tuple[dict, list]:
    """The four ``examples_torch`` scripts, each through its ``main`` on the
    card and with ``--device cpu`` (the plain versions; ``cpu_half``, the
    host worker's pending :func:`examples_cpu_half`, started beside the
    earlier phases), its output captured.  Quickstart, fault tolerance and
    the serving example (its
    weights drawn once on the CPU, a copy on the card) print the same
    text on both.  The training example's two calls (EXAMPLE_CALLS, from
    one set of seeded weights; a data host failed, the async save at 50,
    the second call resumed, the compression demo in a world of one rank:
    ``nccl`` on the card, ``gloo`` on the CPU) print losses within
    EXAMPLE_LOSS_TOL at every printed step and every other line equal,
    the compressed-grad solution included.  On the card: the fused WF
    kernel's launches equal the ``wf_torch`` adapter calls (plus the
    serving example's one MoE balancing call) and are above 0 in every
    example; K3 launches in the quickstart, K4 and K5 in the serving
    example, K4 and K7 in training; no K1/K2 launch, no plain call, no
    host RD re-run.  Returns the card runs' launches by example and their
    counts in ``_model_counts``' form."""
    rows = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name in EXAMPLES:
            t0 = time.perf_counter()
            _reset_launches()
            _reset_model_counts()
            lines, seconds = _example_side(name, "cuda", _example_cpu_params(name),
                                           tmp if name == "train_locality" else None)
            rows[name] = {"output": {"cuda": lines}, "seconds": {"cuda": seconds},
                          "launches": _example_launches(), "counts": _model_counts(),
                          "wall_s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    cpu = cpu_half.get()
    waited = time.perf_counter() - t0
    for name, row in rows.items():
        row["output"]["cpu"], row["seconds"]["cpu"] = cpu["examples"][name]
    emit({"phase": "examples", "card": card, "loss_tol": EXAMPLE_LOSS_TOL,
          "cpu_half": {"wall_s": cpu["wall_s"], "waited_s": waited,
                       "threads": EXAMPLE_CPU_THREADS},
          "examples": {name: {"output": r["output"]["cuda"], "seconds": r["seconds"],
                              "wall_s": r["wall_s"], "launches": r["launches"]}
                       for name, r in rows.items()}})
    for name, row in rows.items():
        card_out, cpu_out = row["output"]["cuda"], row["output"]["cpu"]
        if name == "train_locality":
            got, want = _example_steps(card_out), _example_steps(cpu_out)
            same = ([s for s, _ in got] == [s for s, _ in want] and len(got) > 0
                    and all(abs(a - b) <= round(EXAMPLE_LOSS_TOL * 1e4)
                            for (_, a), (_, b) in zip(got, want)))
            rest = [[line for line in out if not line.startswith("step ")]
                    for out in (card_out, cpu_out)]
            same = same and rest[0] == rest[1]
        else:
            same = card_out == cpu_out
        if not same:
            raise AssertionError(f"examples: {name} printed on the card\n{card_out}\n"
                                 f"and on the CPU\n{cpu_out}")
        n = row["launches"]
        moe_calls = 1 if name == "serve_moe_balanced" else 0  # balance_expert_replicas
        need = {"quickstart": ("rd_step",), "serve_moe_balanced": ("rmsnorm", "decode_attention"),
                "train_locality": ("rmsnorm", "ssd_scan")}.get(name, ())
        if (n["wf_fused"] == 0 or n["wf_fused"] != n["wf_adapter_calls"] + moe_calls
                or any(n[k] == 0 for k in need) or n["waterlevel"] or n["plain"]
                or n["rd_host_reruns"]):
            raise AssertionError(f"examples: {name} went around the kernels: {n}")
    return ({name: r["launches"] for name, r in rows.items()},
            [r["counts"] for r in rows.values()])


def slice15_phases(card: str, cpu_half) -> tuple[dict, list]:
    """The examples phase; its wall on the ``slice15_phases`` line."""
    t0 = time.perf_counter()
    out = phase_examples(card, cpu_half)
    seconds = {"examples": time.perf_counter() - t0}
    emit({"phase": "slice15_phases", "seconds": seconds, "total_s": sum(seconds.values()),
          "budget_s": SLICE15_BUDGET_S, "card": card})
    return out


# ---- slice 16: the partitioned dense train and prefill steps -------------------


def _partition_fake_probe() -> str | None:
    """Whether torch's ``fake`` backend takes CUDA tensors: None if an
    all-gather of a CUDA tensor on a (16, 16) mesh's group returns, else
    the refusal."""
    try:
        with dry.fake_world(math.prod(PARTITION_FAKE_MESH)):
            mesh = make_mesh(PARTITION_FAKE_MESH, ("data", "model"), "cuda")
            x = torch.ones(4, device="cuda")
            out = x.new_empty(4 * PARTITION_FAKE_MESH[1])
            dist.all_gather_into_tensor(out, x, group=mesh.get_group("model"))
            torch.cuda.synchronize()
    except (RuntimeError, ValueError, NotImplementedError) as e:
        return f"{type(e).__name__}: {e}"
    return None


def _partition_fake(seed: int) -> dict:
    """Rank 0 of a fake (16, 16) world at Qwen3-32B's full width, 2 layers,
    train_4k's 256 x 4096 (16 rows a data rank): the partitioned train
    step counted on ``meta`` (a CPU mesh) and run on the card (a CUDA
    mesh), counted the same way; FLOPs and collective calls equal, the
    meta peak within PARTITION_PEAK_TOL of ``max_memory_allocated``, K6's
    counted operations those of its 4 local query heads.  The collectives
    return at once and leave their outputs' contents undefined: only
    shapes and counts are compared.  (The peak is held at the cell's own
    rows: a CUDA reduction in K4's backward allocates a buffer of ~84 MB
    below the dispatcher, which no count sees, whatever the rows.)"""
    layers, b, s = PARTITION_FAKE
    cfg = get_config(PARTITION_FAKE_ARCH).scaled(n_layers=layers)
    shape = ShapeSpec("partition_fake", "train", s, b)
    opt_cfg = TrainAdamWConfig()
    world = math.prod(PARTITION_FAKE_MESH)
    with dry.fake_world(world):
        mesh = make_mesh(PARTITION_FAKE_MESH, ("data", "model"), "cpu")
        fn, args = step_fn_for(cfg, shape, opt_cfg, mesh=mesh,
                               in_shardings=dry.shardings_for(mesh, cfg, shape, opt_cfg))
        out, meta = dry.count_step(fn, args)
        del fn, args, out
    gen = torch.Generator(device="cuda").manual_seed(seed + 291)
    _free()
    with dry.fake_world(world):
        mesh = make_mesh(PARTITION_FAKE_MESH, ("data", "model"), "cuda")
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        fn, args = step_fn_for(cfg, shape, opt_cfg, mesh=mesh, device="cuda",
                               in_shardings=dry.shardings_for(mesh, cfg, shape, opt_cfg))
        _fill_step_args("train", args, gen, cfg.vocab)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_model_counts()
        t0 = time.perf_counter()
        out, card = dry.count_step(fn, args, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        counts = _model_counts()
        del fn, args, out
    heads = cfg.n_heads // PARTITION_FAKE_MESH[1]
    k6 = card.kernels["flash_attention"]
    per_call = fak.op_count(b // PARTITION_FAKE_MESH[0], heads, s, s, cfg.head_dim_, True,
                            fak.route(cfg.torch_dtype, cfg.head_dim_))
    row = {"arch": PARTITION_FAKE_ARCH, "layers": layers, "batch": [b, s],
           "mesh": list(PARTITION_FAKE_MESH), "rank": 0,
           "attention": partition.attention_mode(cfg, PARTITION_FAKE_MESH[1]),
           "flops_meta": meta.flops, "flops_cuda": card.flops,
           "peak_bytes_meta": meta.peak_bytes, "peak_bytes_cuda": peak,
           "peak_ratio": meta.peak_bytes / peak,
           "collective_ops_meta": meta.collective_ops, "collective_ops_cuda": card.collective_ops,
           "k6_calls": k6["calls"], "k6_local_heads": heads,
           "k6_ops": k6["ops"], "k6_ops_at_local_heads": k6["calls"] * per_call,
           "launches": _launches(counts), "plain_calls": _plain_calls(counts),
           "wall_s": wall}
    row["checks"] = {
        "flops_equal": meta.flops == card.flops,
        "peak_within_tol": abs(meta.peak_bytes / peak - 1) <= PARTITION_PEAK_TOL,
        "k6_on_local_heads": k6["calls"] > 0 and k6["ops"] == k6["calls"] * per_call,
        "launches_equal_meta_calls": row["launches"]["flash_attention"] == k6["calls"]
        and row["launches"]["rmsnorm"] == card.kernels["rmsnorm"]["calls"]
        == meta.kernels["rmsnorm"]["calls"],
        "collectives_equal": meta.collective_ops == card.collective_ops,
        "no_plain_call": row["plain_calls"] == 0,
    }
    return {"row": row, "counts": counts}


def phase_partition_check(seed: int, card: str) -> dict:
    """The partitioned strategy on the card (``parallel/partition.py``).
    (a) In a world of one NCCL rank on a (1, 1) mesh, at Qwen1.5-4B's full
    width, PARTITION_MODEL's 2 layers and 2 x 1024, bf16 with bf16
    moments: the partitioned prefill (through ``step_fn_for``, as the dry
    run builds it) against ``prefill``, bit for bit; the partitioned
    train step (``make_train_step(..., mesh=)``, remat on) against the
    single-device step, PARTITION_STEPS steps from one seeded state,
    within PR 25's limits; K4 and K6 launched as often on both sides, no
    plain call.  (b) Where torch's ``fake`` backend takes CUDA tensors,
    rank 0 of a fake (16, 16) world at Qwen3-32B's full width
    (:func:`_partition_fake`); else the refusal on a line of its own.
    Returns the launches of both parts' runs in ``_model_counts``' form."""
    layers, b, s = PARTITION_MODEL
    cfg = get_config(PARTITION_ARCH).scaled(n_layers=layers)
    opt_cfg = TrainAdamWConfig(**TRAIN_OPT)
    gen = torch.Generator(device="cuda").manual_seed(seed + 290)
    state = train_state_init(gen, cfg, opt_cfg)
    batch = _loader_batch(cfg, b, s, seed)
    shape = ShapeSpec("partition_prefill", "prefill", s, b)
    counts_all = []
    with one_rank_world() as mesh:
        _reset_model_counts()
        with torch.no_grad():
            want_logits, want_cache = prefill(state.params, cfg, {"tokens": batch["tokens"]})
        single_pre = _model_counts()
        fn, args = step_fn_for(cfg, shape, opt_cfg, mesh=mesh, device="cuda",
                               in_shardings=dry.shardings_for(mesh, cfg, shape, opt_cfg))
        full = dict(_tree_paths(state.tree()["params"]))
        with torch.no_grad():  # a (1, 1) mesh's blocks are the whole tensors
            for path, t in _tree_paths(args[0]):
                t.to_local().copy_(full[path])
            args[1]["tokens"].to_local().copy_(batch["tokens"])
        _reset_model_counts()
        got_logits, got_cache = fn(*args)
        part_pre = _model_counts()
        del fn, args, full
        prefill_row = {
            "logits_bit_equal": bool(torch.equal(got_logits, want_logits)),
            "cache_bit_equal": all(bool(torch.equal(got_cache["layers"][k],
                                                    want_cache["layers"][k]))
                                   for k in ("k", "v")),
            "logits_max_abs_err": float((got_logits - want_logits).abs().max()),
            "launches": {"partitioned": _launches(part_pre), "single": _launches(single_pre)},
            "plain_calls": _plain_calls(part_pre) + _plain_calls(single_pre)}
        del got_logits, got_cache, want_logits, want_cache
        counts_all += [part_pre, single_pre]
        run = _parallel_run(cfg, opt_cfg, state, batch, mesh, PARTITION_STEPS, remat=True)
    del state
    _free()
    sh, si = run["sharded"], run["single"]
    n = len(sh["losses"])
    train_row = {
        "steps": n, "losses_partitioned": sh["losses"], "losses_single": si["losses"],
        "loss_distance": max(abs(a - c) for a, c in zip(sh["losses"], si["losses"])),
        "param_distance": _max_diff(sh["params"], si["params"]),
        "step_ms_partitioned": [w * 1e3 for w in sh["walls_s"]],
        "step_ms_single": [w * 1e3 for w in si["walls_s"]],
        "step_gb_partitioned": sh["step_gb"], "step_gb_single": si["step_gb"],
        "launches_per_step": {side: {"rmsnorm": r["k4"] / n, "flash_attention": r["k6"] / n}
                              for side, r in (("partitioned", sh), ("single", si))},
        "plain_calls": sh["plain"] + si["plain"]}
    counts_all += [sh["counts"], si["counts"]]
    per_step = {"rmsnorm": 2 * (2 * cfg.n_layers) + 1, "flash_attention": 2 * cfg.n_layers}
    ok = (prefill_row["logits_bit_equal"] and prefill_row["cache_bit_equal"]
          and prefill_row["launches"]["partitioned"] == prefill_row["launches"]["single"]
          and prefill_row["plain_calls"] == 0
          and train_row["loss_distance"] <= PARALLEL_TOL["loss"]
          and train_row["param_distance"] <= PARALLEL_TOL["params"]
          and train_row["launches_per_step"]["partitioned"]
          == train_row["launches_per_step"]["single"] == per_step
          and train_row["plain_calls"] == 0)
    refused = _partition_fake_probe()
    fake = None
    if refused is None:
        fake = _partition_fake(seed)
        counts_all.append(fake["counts"])
        ok &= all(fake["row"]["checks"].values())
    else:
        print(f"partition_check: the fake backend refuses CUDA tensors ({refused}); "
              "the (1, 1) check stands alone", flush=True)
    emit({"phase": "partition_check", "card": card, "arch": PARTITION_ARCH,
          "reduced": {"depth": f"{cfg.n_layers} of {get_config(PARTITION_ARCH).n_layers} "
                      "layers", "batch": [b, s]},
          "world": "one NCCL rank on cuda:0, a (1, 1) (data, model) mesh",
          "attention": partition.attention_mode(cfg, 1), "tolerance": PARALLEL_TOL,
          "want_launches_per_step": per_step, "prefill": prefill_row, "train": train_row,
          "fake_world": fake["row"] if fake else {"refused": refused}})
    if not ok:
        raise AssertionError(f"partition_check failed: prefill {prefill_row}, train "
                             f"{train_row}, fake {fake['row'] if fake else refused}")
    return {k: {c: sum(x[k][c] for x in counts_all) for c in counts_all[0][k]}
            for k in counts_all[0]}


def slice16_phases(seed: int, card: str) -> dict:
    """The partition check; its wall on the ``slice16_phases`` line."""
    t0 = time.perf_counter()
    counts = phase_partition_check(seed, card)
    seconds = {"partition_check": time.perf_counter() - t0}
    emit({"phase": "slice16_phases", "seconds": seconds, "total_s": sum(seconds.values()),
          "budget_s": SLICE16_BUDGET_S, "card": card})
    return counts


# ---- slice 17: the partitioned dense decode step ---------------------------------


def _k5_partial_bound(q: torch.Tensor, hkv: int, t: int, pos: torch.Tensor) -> tuple[float, str]:
    """The partial mode's bound at this run's positions: q read, the fp32
    output and ``lse`` written, each row's keys ``t <= pos`` (clamped to the
    shard) of K and V read once, ``pos`` read."""
    b, h, hd = q.shape
    item = q.element_size()
    keys = int((pos.clamp(min=-1, max=t - 1) + 1).sum())
    nbytes = b * h * hd * (item + 4) + 4 * b * h + 2 * keys * hkv * hd * item + 4 * b
    return _bound(nbytes, 4 * keys * h * hd, PEAK_BF16_FLOPS)


def _k5_partial_case(gen: torch.Generator, shape: tuple, dtype, pos: list) -> dict:
    """K5's partial mode against its plain version on one set of inputs:
    ``out`` (fp32 from either input dtype) within MODEL_TOL's float32
    limits, ``lse`` within K5_LSE_TOL, the same rows at ``-inf``."""
    b, h, hkv, t, hd = shape
    q = _randn(gen, (b, h, hd), dtype)
    k, v = _randn(gen, (b, hkv, t, hd), dtype), _randn(gen, (b, hkv, t, hd), dtype)
    p = torch.tensor(pos, dtype=torch.int32, device="cuda")
    out, lse = dak.decode_attention_partial(q, k, v, p)
    want_out, want_lse = dak.decode_attention_partial_plain(q, k, v, p)
    torch.cuda.synchronize()
    empty = want_lse == float("-inf")
    out_err, out_ok = _model_err(out, want_out, "float32")
    lse_err = float((lse[~empty] - want_lse[~empty]).abs().max())
    return {"shape": list(shape), "dtype": str(dtype).removeprefix("torch."), "pos": pos,
            "out_max_abs_err": out_err, "lse_max_abs_err": lse_err,
            "empty_rows": int(empty.all(dim=1).sum()),
            "ok": out_ok and lse_err <= K5_LSE_TOL
            and bool(torch.equal(lse == float("-inf"), empty))
            and bool((out[empty] == 0).all())}


def _k5_partial_checks(seed: int) -> dict:
    """K5's partial mode on the card: against its plain version at Qwen3-32B
    decode_32k's shard (bf16), a group-1 shape and float32, with rows
    whose shard is full, partial and empty; 16 shards of one 32,768-row
    cache combined against the whole-cache K5 (its bf16 tolerance); and
    the timings at the shard shape of both modes, the plain version and
    ``F.scaled_dot_product_attention``."""
    F = torch.nn.functional
    gen = torch.Generator(device="cuda").manual_seed(seed + 310)
    b, h, hkv, t, hd = K5_SHARD
    # rows past the shard (full), inside it (partial), before it (empty)
    pos = [t + 5000, t - 1, t, 1000, 37, 0, -1, -t]
    cases = [_k5_partial_case(gen, K5_SHARD, torch.bfloat16, pos),
             _k5_partial_case(gen, (b, hkv, hkv, t, hd), torch.bfloat16, pos),
             _k5_partial_case(gen, K5_SHARD, torch.float32, pos)]
    width, whole_t = t, t * K5_SHARDS
    q = _randn(gen, (b, h, hd), torch.bfloat16)
    k = _randn(gen, (b, hkv, whole_t, hd), torch.bfloat16)
    v = _randn(gen, (b, hkv, whole_t, hd), torch.bfloat16)
    gpos = torch.tensor([whole_t - 1, 0, width - 1, width, 15000, 30000, 100, 20000],
                        dtype=torch.int32, device="cuda")
    whole = dak.decode_attention(q, k, v, gpos)
    parts = [dak.decode_attention_partial(q, k[:, :, r * width:(r + 1) * width].contiguous(),
                                          v[:, :, r * width:(r + 1) * width].contiguous(),
                                          gpos - r * width) for r in range(K5_SHARDS)]
    combined = dak.combine_partials(torch.stack([o for o, _ in parts]),
                                    torch.stack([lse for _, lse in parts]))
    torch.cuda.synchronize()
    comb_err, comb_ok = _model_err(combined, whole, "bfloat16")
    del k, v, parts, whole, combined
    q = _randn(gen, (b, h, hd), torch.bfloat16)
    k, v = _randn(gen, (b, hkv, t, hd), torch.bfloat16), _randn(gen, (b, hkv, t, hd), torch.bfloat16)
    full = torch.full((b,), t - 1, dtype=torch.int32, device="cuda")
    partial = _rotating(dak.decode_attention_partial, (q, k, v, full))
    timed = _time_three(partial, _rotating(dak.decode_attention_partial_plain, (q, k, v, full)),
                        _rotating(lambda *a: F.scaled_dot_product_attention(
                            a[0][:, :, None], a[1], a[2], enable_gqa=True), (q, k, v)), 200)
    timed["whole_mode_ms"] = device_ms_per_call(
        _rotating(dak.decode_attention, (q, k, v, full)), 200)
    bound, by = _k5_partial_bound(q, hkv, t, full)
    row = {"shape": list(K5_SHARD), "pos": t - 1, **timed, "bound_ms": bound, "bound_by": by,
           "chunk_splits": dak.split_plan(b, hkv, t, _sms(), h // hkv)}
    return {"cases": cases, "combine": {"shards": K5_SHARDS, "cache": whole_t,
                                        "pos": gpos.tolist(), "max_abs_err": comb_err,
                                        "ok": comb_ok},
            "timed": row, "max_abs_err": max([comb_err] + [c["out_max_abs_err"]
                                                           for c in cases]),
            "ok": comb_ok and all(c["ok"] for c in cases)}


def _partition_decode_one_rank(seed: int, mesh) -> dict:
    """On a (1, 1) mesh, Qwen1.5-4B at full width, PARTITION_MODEL's 2
    layers, 2 x 1024 prompts: the partitioned prefill and then
    PARTITION_DECODE_STEPS partitioned decode steps, both built by
    ``step_fn_for`` as the dry run builds them (the decode cell's cache
    holds the prefill's rows and room for the steps), each side feeding
    its own greedy tokens, against ``prefill`` + ``decode_step``: tokens,
    logits and caches bit for bit (a ``model`` group of one takes K5's
    whole-cache launch), K4 / K5 launches equal, no plain call."""
    layers, b, s = PARTITION_MODEL
    n = PARTITION_DECODE_STEPS
    cfg = get_config(PARTITION_ARCH).scaled(n_layers=layers)
    opt_cfg = TrainAdamWConfig()
    gen = torch.Generator(device="cuda").manual_seed(seed + 300)
    params = init_params(gen, cfg)
    toks = torch.randint(0, cfg.vocab, (b, s), generator=gen, device="cuda", dtype=torch.int32)
    full = dict(_tree_paths(param_tree(params)))
    _reset_model_counts()
    want, cache = prefill(params, cfg, {"tokens": toks}, max_len=s + n)
    want_tokens, want_logits = [], [want]
    for _ in range(n):
        nxt = want_logits[-1][:, -1].argmax(-1, keepdim=True).to(torch.int32)
        want_tokens.append(nxt)
        logits, cache = decode_step(params, cfg, nxt, cache)
        want_logits.append(logits)
    single = _model_counts()
    pre = ShapeSpec("partition_decode_prefill", "prefill", s, b)
    dec = ShapeSpec("partition_decode", "decode", s + n, b)

    def built(shape):
        fn, args = step_fn_for(cfg, shape, opt_cfg, mesh=mesh, device="cuda",
                               in_shardings=dry.shardings_for(mesh, cfg, shape, opt_cfg))
        with torch.no_grad():  # a (1, 1) mesh's blocks are the whole tensors
            for path, t in _tree_paths(args[0]):
                t.to_local().copy_(full[path])
        return fn, args

    _reset_model_counts()
    fn, args = built(pre)
    args[1]["tokens"].to_local().copy_(toks)
    got, pcache = fn(*args)
    del fn, args
    fn, (blocks, tokens, dcache) = built(dec)
    with torch.no_grad():
        for key in ("k", "v"):
            dcache["layers"][key].to_local()[:, :, :, :s].copy_(pcache["layers"][key])
        dcache["pos"].to_local().copy_(pcache["pos"])
    got_tokens, got_logits = [], [got]
    for _ in range(n):
        nxt = got_logits[-1][:, -1].argmax(-1, keepdim=True).to(torch.int32)
        got_tokens.append(nxt)
        tokens.to_local().copy_(nxt)
        logits, dcache = fn(blocks, tokens, dcache)
        got_logits.append(logits)
    part = _model_counts()
    same_cache = all(bool(torch.equal(dcache["layers"][k].to_local(), cache["layers"][k]))
                     for k in ("k", "v")) and bool(torch.equal(dcache["pos"].to_local(),
                                                               cache["pos"]))
    row = {
        "arch": PARTITION_ARCH, "layers": layers, "batch": [b, s], "decode_steps": n,
        "tokens_equal": all(bool(torch.equal(a, c)) for a, c in zip(got_tokens, want_tokens)),
        "logits_bit_equal": all(bool(torch.equal(a, c))
                                for a, c in zip(got_logits, want_logits)),
        "logits_max_abs_err": max(float((a - c).abs().max())
                                  for a, c in zip(got_logits, want_logits)),
        "cache_bit_equal": same_cache,
        "launches": {"partitioned": _launches(part), "single": _launches(single)},
        "k5_partial_launches": part["decode_attention"]["decode_attention_partial"],
        "plain_calls": _plain_calls(part) + _plain_calls(single)}
    row["ok"] = (row["tokens_equal"] and row["logits_bit_equal"] and same_cache
                 and row["launches"]["partitioned"] == row["launches"]["single"]
                 and row["launches"]["single"]["decode_attention"] == n * layers
                 and row["k5_partial_launches"] == 0 and row["plain_calls"] == 0)
    return {"row": row, "counts": [part, single]}


def _partition_decode_fake(seed: int) -> dict:
    """Rank 0 of a fake (16, 16) world at Qwen3-32B's full width, 2 layers,
    decode_32k's 128 x 32,768 (a block of 8 rows x 2,048 positions on a
    rank): the partitioned decode step counted on ``meta`` (a CPU mesh)
    and run on the card (a CUDA mesh), counted the same way; FLOPs and
    collective calls equal, the meta peak within PARTITION_PEAK_TOL of
    ``max_memory_allocated``, one K5 partial launch a layer over the
    rank's 2,048 positions and no whole-cache one, K4 launches = meta
    calls, no plain call.  The collectives return at once, their outputs
    undefined: only shapes and counts are compared.  The counts are set
    to 0 just before the card's step and read just after it."""
    layers, b, s = PARTITION_DECODE_FAKE
    cfg = get_config(PARTITION_FAKE_ARCH).scaled(n_layers=layers)
    shape = ShapeSpec("partition_decode_fake", "decode", s, b)
    opt_cfg = TrainAdamWConfig()
    world = math.prod(PARTITION_FAKE_MESH)
    with dry.fake_world(world):
        mesh = make_mesh(PARTITION_FAKE_MESH, ("data", "model"), "cpu")
        fn, args = step_fn_for(cfg, shape, opt_cfg, mesh=mesh,
                               in_shardings=dry.shardings_for(mesh, cfg, shape, opt_cfg))
        out, meta = dry.count_step(fn, args)
        del fn, args, out
    gen = torch.Generator(device="cuda").manual_seed(seed + 311)
    _free()
    with dry.fake_world(world):
        mesh = make_mesh(PARTITION_FAKE_MESH, ("data", "model"), "cuda")
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        fn, args = step_fn_for(cfg, shape, opt_cfg, mesh=mesh, device="cuda",
                               in_shardings=dry.shardings_for(mesh, cfg, shape, opt_cfg))
        _fill_step_args("decode", args, gen, cfg.vocab)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_model_counts()
        t0 = time.perf_counter()
        out, card = dry.count_step(fn, args, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        counts = _model_counts()
        del fn, args, out
    _free()
    b_l, s_l = b // PARTITION_FAKE_MESH[0], s // PARTITION_FAKE_MESH[1]
    k5 = card.kernels["decode_attention_partial"]
    per_call = dak.op_count(b_l, cfg.n_heads, cfg.n_kv_heads, s_l, cfg.head_dim_)
    row = {"arch": PARTITION_FAKE_ARCH, "layers": layers, "batch": [b, s],
           "block": [b_l, s_l], "mesh": list(PARTITION_FAKE_MESH), "rank": 0,
           "flops_meta": meta.flops, "flops_cuda": card.flops,
           "peak_bytes_meta": meta.peak_bytes, "peak_bytes_cuda": peak,
           "peak_ratio": meta.peak_bytes / peak,
           "collective_ops_meta": meta.collective_ops, "collective_ops_cuda": card.collective_ops,
           "collective_wire_bytes": card.collective_wire_bytes,
           "k5_partial_calls": k5["calls"], "k5_partial_ops": k5["ops"],
           "k5_ops_at_local_positions": k5["calls"] * per_call,
           "launches": _launches(counts),
           "k5_partial_launches": counts["decode_attention"]["decode_attention_partial"],
           "plain_calls": _plain_calls(counts), "wall_s": wall}
    row["checks"] = {
        "flops_equal": meta.flops == card.flops,
        "peak_within_tol": abs(meta.peak_bytes / peak - 1) <= PARTITION_PEAK_TOL,
        "collectives_equal": meta.collective_ops == card.collective_ops,
        "k5_partial_a_layer": row["k5_partial_launches"] == layers == k5["calls"]
        and row["launches"]["decode_attention"] == 0,
        "k5_on_local_positions": k5["ops"] == k5["calls"] * per_call,
        "k4_launches_equal_meta_calls": row["launches"]["rmsnorm"]
        == card.kernels["rmsnorm"]["calls"] == meta.kernels["rmsnorm"]["calls"],
        "no_plain_call": row["plain_calls"] == 0,
    }
    return {"row": row, "counts": counts}


def phase_partition_decode(seed: int, card: str) -> tuple[dict, dict]:
    """The partitioned dense decode on the card (``Partitioned.decode``):
    (a) :func:`_partition_decode_one_rank` in a world of one NCCL rank;
    (b) K5's partial mode (:func:`_k5_partial_checks`); (c) where torch's
    ``fake`` backend takes CUDA tensors (the slice-16 probe),
    :func:`_partition_decode_fake`, else the refusal on a line of its own.
    Every check is made, the line emitted, and then a failure raises.
    Returns the main-path launches of (a) and (c) in ``_model_counts``'
    form, and (b)'s row for the ``kernels`` line."""
    with one_rank_world() as mesh:
        one = _partition_decode_one_rank(seed, mesh)
    _free()
    _reset_model_counts()
    kernel = _k5_partial_checks(seed)
    _free()
    refused = _partition_fake_probe()
    fake = _partition_decode_fake(seed) if refused is None else None
    if refused is not None:
        print(f"partition_decode: the fake backend refuses CUDA tensors ({refused}); "
              "the (1, 1) and kernel checks stand alone", flush=True)
    emit({"phase": "partition_decode", "card": card,
          "reduced": {"one_rank": f"{PARTITION_MODEL[0]} of "
                      f"{get_config(PARTITION_ARCH).n_layers} layers",
                      "fake_world": f"{PARTITION_DECODE_FAKE[0]} of "
                      f"{get_config(PARTITION_FAKE_ARCH).n_layers} layers"},
          "world": "one NCCL rank on cuda:0, a (1, 1) (data, model) mesh",
          "one_rank": one["row"], "k5_partial": kernel,
          "k5_lse_tol": K5_LSE_TOL, "fake_world": fake["row"] if fake else {"refused": refused}})
    ok = one["row"]["ok"] and kernel["ok"] and (fake is None or all(fake["row"]["checks"].values()))
    if not ok:
        raise AssertionError(f"partition_decode failed: one rank {one['row']}, kernel "
                             f"{kernel['cases']} {kernel['combine']}, fake "
                             f"{fake['row'] if fake else refused}")
    counts_all = one["counts"] + ([fake["counts"]] if fake else [])
    counts = {k: {c: sum(x[k][c] for x in counts_all) for c in counts_all[0][k]}
              for k in counts_all[0]}
    return counts, kernel


def slice17_phases(seed: int, card: str) -> tuple[dict, dict]:
    """The partitioned decode; its wall on the ``slice17_phases`` line."""
    t0 = time.perf_counter()
    counts, kernel = phase_partition_decode(seed, card)
    seconds = {"partition_decode": time.perf_counter() - t0}
    emit({"phase": "slice17_phases", "seconds": seconds, "total_s": sum(seconds.values()),
          "budget_s": SLICE17_BUDGET_S, "card": card})
    return counts, kernel


# ---- slice 18: the partitioned MoE and MLA + MoE steps ----------------------------


def _shared_blocks(mesh, tree: dict, specs: dict) -> dict:
    """``DTensor`` s on a (1, 1) mesh placed by ``specs`` that share the
    storage of ``tree`` 's tensors (each block is the whole tensor): the
    partitioned and the single-device sides read the same weights, and no
    copy of a 22.5 GB layer is made."""
    from repro_torch.parallel.sharding import placements
    from torch.distributed.tensor import DTensor
    flat = dict(_tree_paths(specs))
    out: dict = {}
    for path, t in _tree_paths(tree):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = DTensor.from_local(t.detach(), mesh, placements(mesh, flat[path]),
                                            run_check=False, shape=t.shape, stride=t.stride())
    return out


def _cache_prefix(path: tuple, t: torch.Tensor, s: int) -> torch.Tensor:
    """A cache leaf's first ``s`` positions (a K/V leaf (L, B, H, S, hd),
    MLA's (L, B, S, r)); a Mamba2 state whole."""
    if path[-1] in ("k", "v"):
        return t[..., :s, :]
    return t[:, :, :s] if path[-1] in ("c_kv", "k_rope") else t


def _tree_clone(tree: dict) -> dict:
    return {k: _tree_clone(v) if isinstance(v, dict) else v.clone() for k, v in tree.items()}


def _partition_one_rank(seed: int, mesh, arch: str, cfg, b: int, s: int,
                        train: bool) -> dict:
    """On a (1, 1) mesh, ``cfg`` (``arch`` at full width, its depth cut by
    the caller): the partitioned prefill and PARTITION_DECODE_STEPS
    partitioned decode steps (``specs._partitioned_prefill`` /
    ``_partitioned_decode``, the blocks sharing the model's storage), each
    side feeding its own greedy tokens, against ``prefill`` +
    ``decode_step``: tokens, logits and caches bit for bit (a ``model``
    group of one runs every shape and operation the one device runs); with
    ``train``, one partitioned train step (remat on) against the
    single-device step from one state, within PR 25's limits; K4 / K5 /
    K6 / K7 launches equal, no plain call.  The counts are set to 0 just
    before each side's run and read just after."""
    from repro_torch.launch import specs as launch_specs
    from repro_torch.parallel.sharding import (batch_sharding, cache_sharding,
                                               param_sharding)
    from repro_torch.train.step import state_sharding
    n = PARTITION_DECODE_STEPS
    gen = torch.Generator(device="cuda").manual_seed(seed + 320)
    opt_cfg = TrainAdamWConfig(**TRAIN_OPT)
    state = train_state_init(gen, cfg, opt_cfg) if train else None
    params = state.params if state is not None else init_params(gen, cfg)
    toks = torch.randint(0, cfg.vocab, (b, s), generator=gen, device="cuda", dtype=torch.int32)
    _reset_model_counts()
    want, cache = prefill(params, cfg, {"tokens": toks}, max_len=s + n)
    start = _tree_clone(cache["layers"])
    want_tokens, want_logits = [], [want]
    for _ in range(n):
        nxt = want_logits[-1][:, -1].argmax(-1, keepdim=True).to(torch.int32)
        want_tokens.append(nxt)
        logits, cache = decode_step(params, cfg, nxt, cache)
        want_logits.append(logits)
    torch.cuda.synchronize()
    single = _model_counts()
    tree = param_tree(params)
    blocks = _shared_blocks(mesh, tree, param_sharding(mesh, params))
    prompt = {"tokens": toks}
    placed = _shared_blocks(mesh, prompt, batch_sharding(mesh, prompt))
    _reset_model_counts()
    got, pcache = launch_specs._partitioned_prefill(cfg, mesh)(blocks, placed)
    begun = dict(_tree_paths(start))
    prefill_equal = all(bool(torch.equal(t, _cache_prefix(path, begun[path], s)))
                        for path, t in _tree_paths(pcache["layers"]))
    dcache = {"layers": start, "pos": pcache["pos"].clone()}
    dplaced = _shared_blocks(mesh, dcache, cache_sharding(mesh, dcache))
    step = launch_specs._partitioned_decode(cfg, mesh)
    got_tokens, got_logits = [], [got]
    for _ in range(n):
        nxt = got_logits[-1][:, -1].argmax(-1, keepdim=True).to(torch.int32)
        got_tokens.append(nxt)
        tok = _shared_blocks(mesh, {"tokens": nxt}, batch_sharding(mesh, {"tokens": nxt}))
        logits, dplaced = step(blocks, tok["tokens"], dplaced)
        got_logits.append(logits)
    torch.cuda.synchronize()
    part = _model_counts()
    final = dict(_tree_paths(cache["layers"]))
    row = {
        "arch": arch, "layers": cfg.n_layers, "batch": [b, s], "decode_steps": n,
        "tokens_equal": all(bool(torch.equal(a, c)) for a, c in zip(got_tokens, want_tokens)),
        "logits_bit_equal": all(bool(torch.equal(a, c))
                                for a, c in zip(got_logits, want_logits)),
        "logits_max_abs_err": max(float((a - c).abs().max())
                                  for a, c in zip(got_logits, want_logits)),
        "prefill_cache_bit_equal": prefill_equal,
        "cache_bit_equal": all(bool(torch.equal(t.to_local(), final[path]))
                               for path, t in _tree_paths(dplaced["layers"])),
        "launches": {"partitioned": _launches_k4_k7(part), "single": _launches_k4_k7(single)},
        "plain_calls": _plain_calls(part) + _plain_calls(single)}
    counts = [part, single]
    del blocks, dplaced, dcache, cache, start, begun, final, got_logits, want_logits
    ok = (row["tokens_equal"] and row["logits_bit_equal"] and prefill_equal
          and row["cache_bit_equal"] and row["plain_calls"] == 0
          and row["launches"]["partitioned"] == row["launches"]["single"])
    if state is not None:
        batch = {"tokens": toks, "targets": torch.roll(toks, -1, dims=1)}
        sharded = _shared_blocks(mesh, state.tree(), state_sharding(mesh, state.tree()))
        sides = {}
        for side in ("partitioned", "single"):  # partitioned first: the single side
            step_fn = make_train_step(cfg, opt_cfg, mesh=mesh if side == "partitioned"
                                      else None)  # updates the shared weights in place
            _reset_model_counts()
            t0 = time.perf_counter()
            st, metrics = step_fn(sharded if side == "partitioned" else state.as_dict(), batch)
            loss = float(metrics["loss"])
            wall = time.perf_counter() - t0
            c = _model_counts()
            counts.append(c)
            out = (dict(_tree_paths(gather_state(st)["params"])) if side == "partitioned"
                   else {tuple(k.split(".")): v.detach() for k, v in
                         st["params"].named_parameters()})
            sides[side] = {"loss": loss, "aux": float(metrics["aux"]), "params": out,
                           "ms": wall * 1e3, "launches": _launches_k4_k7(c),
                           "plain": _plain_calls(c)}
            del st, step_fn
            if side == "partitioned":
                del sharded
        pa, si = sides["partitioned"], sides["single"]
        row["train"] = {"loss": [pa["loss"], si["loss"]], "aux": [pa["aux"], si["aux"]],
                        "loss_distance": abs(pa["loss"] - si["loss"]),
                        "param_distance": _max_diff(pa["params"], si["params"]),
                        "step_ms": [pa["ms"], si["ms"]],
                        "launches": {k: sides[k]["launches"] for k in sides},
                        "plain_calls": pa["plain"] + si["plain"]}
        tr = row["train"]
        ok &= (tr["loss_distance"] <= PARALLEL_TOL["loss"]
               and tr["param_distance"] <= PARALLEL_TOL["params"]
               and tr["launches"]["partitioned"] == tr["launches"]["single"]
               and tr["plain_calls"] == 0)
        del sides, pa, si
    row["ok"] = ok
    del params, state
    _free()
    return {"row": row, "counts": counts}


def _blocks_on_card(tree, seq: int):
    """A step's arguments built on ``meta`` (this rank's ``DTensor`` blocks
    of them) made real on the card: each block zeros, ``pos`` at the
    cache's last position, as ``step_fn_for(device="cuda")`` would cut
    them, without its whole-model copy (2 DeepSeek-V3 layers and the MTP
    block are 69 GB in bf16)."""
    from torch.distributed.tensor import DTensor
    if isinstance(tree, dict):
        out = {k: _blocks_on_card(v, seq) for k, v in tree.items()}
        if "pos" in out:
            out["pos"].to_local().fill_(seq - 1)
        return out
    if isinstance(tree, (list, tuple)):
        return type(tree)(_blocks_on_card(v, seq) for v in tree)
    if isinstance(tree, DTensor):
        local = torch.zeros(tree.to_local().shape, dtype=tree.dtype, device="cuda")
        return DTensor.from_local(local, tree.device_mesh, tree.placements, run_check=False,
                                  shape=tree.shape, stride=tree.stride())
    if isinstance(tree, torch.Tensor):  # the train step's whole batch
        return torch.zeros(tree.shape, dtype=tree.dtype, device="cuda")
    return tree


def _partition_fake_cell(seed: int, arch: str, cfg, shape: ShapeSpec) -> dict:
    """Rank 0 of a fake (16, 16) world at ``cfg`` (``arch``'s full width):
    the partitioned step of ``shape`` counted on ``meta`` (a CPU mesh) and
    run on the card (a CUDA mesh), counted the same way; FLOPs and
    collective calls equal, the meta peak within PARTITION_PEAK_TOL of
    ``max_memory_allocated``, K4 / K5 (both modes) / K6 / K7 launches
    equal to the meta calls, no plain call.  The collectives return at
    once, their outputs undefined: only shapes and counts are compared
    (the MoE's routing indices are clamped, so undefined counts index
    nothing outside its buffers).  The counts are set to 0 just before
    the card's step and read just after it."""
    s, opt_cfg = shape.seq_len, TrainAdamWConfig()
    world = math.prod(PARTITION_FAKE_MESH)
    with dry.fake_world(world):
        mesh = make_mesh(PARTITION_FAKE_MESH, ("data", "model"), "cpu")
        fn, args = step_fn_for(cfg, shape, opt_cfg, mesh=mesh,
                               in_shardings=dry.shardings_for(mesh, cfg, shape, opt_cfg))
        out, meta = dry.count_step(fn, args)
        del fn, args, out
    gen = torch.Generator(device="cuda").manual_seed(seed + 321)
    _free()
    with dry.fake_world(world):
        mesh = make_mesh(PARTITION_FAKE_MESH, ("data", "model"), "cuda")
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        fn, args = step_fn_for(cfg, shape, opt_cfg, mesh=mesh, device="meta",
                               in_shardings=dry.shardings_for(mesh, cfg, shape, opt_cfg))
        args = _blocks_on_card(args, s)
        _fill_step_args(shape.kind, args, gen, cfg.vocab)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_model_counts()
        t0 = time.perf_counter()
        out, card = dry.count_step(fn, args, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        counts = _model_counts()
        del fn, args, out
    _free()
    launches = _launches_k4_k7(counts)
    launches["decode_attention_partial"] = counts["decode_attention"]["decode_attention_partial"]
    calls = {k: v["calls"] for k, v in card.kernels.items()}
    row = {"arch": arch, "kind": shape.kind, "layers": cfg.n_layers, "mtp": bool(cfg.mtp_depth),
           "batch": [shape.global_batch, s], "mesh": list(PARTITION_FAKE_MESH), "rank": 0,
           "flops_meta": meta.flops, "flops_cuda": card.flops,
           "peak_bytes_meta": meta.peak_bytes, "peak_bytes_cuda": peak,
           "peak_ratio": meta.peak_bytes / peak,
           "collective_ops_meta": meta.collective_ops, "collective_ops_cuda": card.collective_ops,
           "collective_wire_bytes": card.collective_wire_bytes,
           "kernel_calls_meta": {k: v["calls"] for k, v in meta.kernels.items()},
           "launches": launches, "plain_calls": _plain_calls(counts), "wall_s": wall}
    row["checks"] = {
        "flops_equal": meta.flops == card.flops,
        "peak_within_tol": abs(meta.peak_bytes / peak - 1) <= PARTITION_PEAK_TOL,
        "collectives_equal": meta.collective_ops == card.collective_ops,
        "launches_equal_meta_calls": all(launches[k] == calls.get(k, 0) == row[
            "kernel_calls_meta"].get(k, 0) for k in ("rmsnorm", "flash_attention",
                                                     "decode_attention",
                                                     "decode_attention_partial", "ssd_scan")),
        "no_plain_call": row["plain_calls"] == 0,
    }
    return {"row": row, "counts": counts}


def phase_partition_moe(seed: int, card: str) -> dict:
    """The partitioned MoE and MLA + MoE steps on the card
    (``parallel/experts.py``, ``Partitioned``'s MoE and MLA paths): (a)
    :func:`_partition_one_rank` for Qwen3-MoE and DeepSeek-V3 at
    PARTITION_MOE_ONE_RANK's cut in a world of one NCCL rank (a ``model``
    group of one runs every MoE shape and operation ``moe_apply`` runs,
    and MLA's whole-cache ``mla_decode``); (b) where torch's ``fake``
    backend takes CUDA tensors (the slice-16 probe),
    :func:`_partition_fake_cell` for both families' train and decode
    steps at PARTITION_MOE_FAKE's cut, else the refusal on a line of its
    own.  Every check is made, the line emitted, and then a failure
    raises.  Returns the launches of (a) and (b) in ``_model_counts``'
    form."""
    one = {}
    with one_rank_world() as mesh:
        for arch, (layers, b, s) in PARTITION_MOE_ONE_RANK.items():
            # DeepSeek-V3 without its MTP block, which serving never runs
            cfg = get_config(arch).scaled(n_layers=layers, mtp_depth=0)
            one[arch] = _partition_one_rank(seed, mesh, arch, cfg, b, s,
                                            train=arch in PARTITION_MOE_TRAINS)
            print(f"partition_moe: {arch} on (1, 1): ok {one[arch]['row']['ok']}", flush=True)
    _free()
    refused = _partition_fake_probe()
    fake = {}
    if refused is None:
        for arch in PARTITION_MOE_ONE_RANK:
            for kind, (layers, b, s) in PARTITION_MOE_FAKE.items():
                fake[f"{arch}/{kind}"] = _partition_fake_cell(
                    seed, arch, get_config(arch).scaled(n_layers=layers),
                    ShapeSpec(f"partition_moe_{kind}", kind, s, b))
    else:
        print(f"partition_moe: the fake backend refuses CUDA tensors ({refused}); "
              "the (1, 1) checks stand alone", flush=True)
    emit({"phase": "partition_moe", "card": card,
          "reduced": {"one_rank": {a: f"{v[0]} of {get_config(a).n_layers} layers, "
                                   f"{v[1]} x {v[2]}" for a, v in PARTITION_MOE_ONE_RANK.items()},
                      "fake_world": {k: f"{v[0]} layers, {v[1]} x {v[2]}"
                                     for k, v in PARTITION_MOE_FAKE.items()}},
          "world": "one NCCL rank on cuda:0, a (1, 1) (data, model) mesh",
          "tolerance": {"train": PARALLEL_TOL, "prefill_decode": "bit for bit"},
          "one_rank": {a: r["row"] for a, r in one.items()},
          "fake_world": {k: r["row"] for k, r in fake.items()} if fake else {"refused": refused}})
    ok = all(r["row"]["ok"] for r in one.values()) and all(
        all(r["row"]["checks"].values()) for r in fake.values())
    if not ok:
        raise AssertionError(f"partition_moe failed: one rank {[r['row'] for r in one.values()]}"
                             f", fake {[r['row'] for r in fake.values()]}")
    counts_all = [c for r in one.values() for c in r["counts"]] + [r["counts"]
                                                                   for r in fake.values()]
    return {k: {c: sum(x[k][c] for x in counts_all) for c in counts_all[0][k]}
            for k in counts_all[0]}


def slice18_phases(seed: int, card: str) -> dict:
    """The partitioned MoE steps; its wall on the ``slice18_phases`` line."""
    t0 = time.perf_counter()
    counts = phase_partition_moe(seed, card)
    seconds = {"partition_moe": time.perf_counter() - t0}
    emit({"phase": "slice18_phases", "seconds": seconds, "total_s": sum(seconds.values()),
          "budget_s": SLICE18_BUDGET_S, "card": card})
    return counts


def phase_partition_ssm(seed: int, card: str) -> dict:
    """The partitioned Mamba2 and Zamba2 steps on the card
    (``parallel/ssm.py``, ``Partitioned`` 's Mamba2 layers, Zamba2's shared
    block and the decode's K/V layouts): (a) :func:`_partition_one_rank`
    for Zamba2-2.7B (one super-block) and Mamba2-130M (all 24 layers),
    prefill, decode and a train step each, in a world of one NCCL rank;
    (b) where torch's ``fake`` backend takes CUDA tensors (the slice-16
    probe), :func:`_partition_fake_cell` for Zamba2-2.7B's train_4k,
    decode_32k (the sequence on ``model``) and long_500k (the sequence on
    ``data``, the KV heads on ``model``) blocks, else the refusal on a
    line of its own.  Every check is made, the line emitted, and then a
    failure raises.  Returns the launches of (a) and (b) in
    ``_model_counts``' form."""
    one = {}
    with one_rank_world() as mesh:
        for arch, (layers, b, s) in PARTITION_SSM_ONE_RANK.items():
            cfg = get_config(arch).scaled(n_layers=layers or get_config(arch).n_layers)
            one[arch] = _partition_one_rank(seed + 10, mesh, arch, cfg, b, s, train=True)
            print(f"partition_ssm: {arch} on (1, 1): ok {one[arch]['row']['ok']}", flush=True)
    _free()
    refused = _partition_fake_probe()
    fake = {}
    if refused is None:
        for name, (kind, layers, b, s) in PARTITION_SSM_FAKE.items():
            cfg = get_config(PARTITION_SSM_ARCH).scaled(n_layers=layers)
            fake[name] = _partition_fake_cell(seed + 10, PARTITION_SSM_ARCH, cfg,
                                              ShapeSpec(f"partition_ssm_{name}", kind, s, b))
    else:
        print(f"partition_ssm: the fake backend refuses CUDA tensors ({refused}); "
              "the (1, 1) checks stand alone", flush=True)
    full = {a: get_config(a).n_layers for a in PARTITION_SSM_ONE_RANK}
    emit({"phase": "partition_ssm", "card": card,
          "reduced": {"one_rank": {a: f"{v[0] or full[a]} of {full[a]} layers, {v[1]} x {v[2]}"
                                   for a, v in PARTITION_SSM_ONE_RANK.items()},
                      "fake_world": {k: f"{v[1]} of {full[PARTITION_SSM_ARCH]} layers, "
                                     f"{v[2]} x {v[3]}" for k, v in PARTITION_SSM_FAKE.items()}},
          "world": "one NCCL rank on cuda:0, a (1, 1) (data, model) mesh",
          "tolerance": {"train": PARALLEL_TOL, "prefill_decode": "bit for bit"},
          "one_rank": {a: r["row"] for a, r in one.items()},
          "fake_world": {k: r["row"] for k, r in fake.items()} if fake else {"refused": refused}})
    ok = all(r["row"]["ok"] for r in one.values()) and all(
        all(r["row"]["checks"].values()) for r in fake.values())
    if not ok:
        raise AssertionError(f"partition_ssm failed: one rank {[r['row'] for r in one.values()]}"
                             f", fake {[r['row'] for r in fake.values()]}")
    counts_all = [c for r in one.values() for c in r["counts"]] + [r["counts"]
                                                                   for r in fake.values()]
    return {k: {c: sum(x[k][c] for x in counts_all) for c in counts_all[0][k]}
            for k in counts_all[0]}


def slice19_phases(seed: int, card: str) -> dict:
    """The partitioned Mamba2 and Zamba2 steps; its wall on the
    ``slice19_phases`` line."""
    t0 = time.perf_counter()
    counts = phase_partition_ssm(seed, card)
    seconds = {"partition_ssm": time.perf_counter() - t0}
    emit({"phase": "slice19_phases", "seconds": seconds, "total_s": sum(seconds.values()),
          "budget_s": SLICE19_BUDGET_S, "card": card})
    return counts


# ---- the MoE and MLA + MoE families: prefill and the handoff -------------------


def _handoff(params, cfg, toks: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Last logits (B, V) fp32 after prefilling all but the last token of
    ``toks`` and decoding it, and those of one prefill over all of them."""
    s = toks.shape[1] - 1
    _, cache = prefill(params, cfg, {"tokens": toks[:, :s]}, max_len=s + 1)
    got, _ = decode_step(params, cfg, toks[:, s:], cache)
    del cache
    want, _ = prefill(params, cfg, {"tokens": toks})
    return got[:, 0].float(), want[:, 0].float()


def _handoff_stats(got: torch.Tensor, want: torch.Tensor) -> dict:
    scale = float(want.abs().max())
    top2 = want.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > PREFILL_REL_TOL * scale
    agree = got.argmax(-1) == want.argmax(-1)
    return {"max_abs_logit": scale, "max_rel_err": float((got - want).abs().max()) / scale,
            "argmax_agree": agree.tolist(), "argmax_gap_clear": clear.tolist(),
            "clear_argmax_agree": bool(agree[clear].all()),
            "finite": bool(torch.isfinite(got).all() and torch.isfinite(want).all())}


def phase_moe_prefill(arch: str, params, cfg, seed: int) -> dict:
    """``make_prefill_step`` at the published capacity factor (K6 on the
    tensor cores once per GQA layer, none for MLA; K4), with the share of
    routed assignments dropped past their expert's capacity; then the
    prefill -> decode handoff at capacity factor E / k, where nothing
    drops (prefill and decode drop differently at 1.25, as in the
    reference): in bf16, then in float32 on the same weights upcast (in
    place: the phase leaves ``params`` in float32, cut to
    ``MOE_F32_LAYERS``)."""
    b = MOE_PREFILL_BATCH[arch]
    gen = torch.Generator(device="cuda").manual_seed(seed + 60)
    toks = torch.randint(1, cfg.vocab, (b, PREFILL_LEN), generator=gen, device="cuda",
                         dtype=torch.int32)
    step = make_prefill_step(cfg)
    step(params, {"tokens": toks[:, :128]})  # warm up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_model_counts()
    moe_ffn.reset_drop_counts()
    t0 = time.perf_counter()
    logits, cache = step(params, {"tokens": toks})
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    counts = _model_counts()
    drops = moe_ffn.drop_counts()
    finite = bool(torch.isfinite(logits).all())
    prefill_peak = torch.cuda.max_memory_allocated() / 1e9
    del cache, logits
    torch.cuda.empty_cache()
    m = cfg.moe
    nodrop = cfg.scaled(moe=dataclasses.replace(m, capacity_factor=m.n_experts / m.top_k))
    hb, hs = MOE_HANDOFF[arch]
    htoks = torch.randint(1, cfg.vocab, (hb, hs + 1), generator=gen, device="cuda",
                          dtype=torch.int32)
    torch.cuda.reset_peak_memory_stats()
    moe_ffn.reset_drop_counts()
    t0 = time.perf_counter()
    got, want = _handoff(params, nodrop, htoks)
    handoff = _handoff_stats(got, want)
    handoff_s = time.perf_counter() - t0
    handoff_peak = torch.cuda.max_memory_allocated() / 1e9
    # float32: the same weights upcast (the first MOE_F32_LAYERS layers)
    keep = MOE_F32_LAYERS[arch]
    cut = nodrop.scaled(n_layers=keep)
    if keep < cfg.n_layers:
        del params.layers[keep:]
        torch.cuda.empty_cache()
        _, want = _handoff(params, cut, htoks)
    params.float()
    torch.cuda.empty_cache()
    got32, want32 = _handoff(params, cut.scaled(dtype="float32"), htoks)
    handoff32 = _handoff_stats(got32, want32)
    handoff_drops = moe_ffn.drop_counts()
    floor = float((want - want32).abs().max()) / handoff32["max_abs_logit"]
    attn = _attn_per_step(cfg)
    emit({
        "phase": f"{arch}_prefill",
        "arch": arch,
        "layers": cfg.n_layers,
        "batch": b,
        "prompt_len": PREFILL_LEN,
        "capacity_factor": m.capacity_factor,
        "capacity": max(1, int(b * PREFILL_LEN * m.top_k / m.n_experts * m.capacity_factor)),
        "prefill_s": prefill_s,
        "prefill_tokens_per_s": b * PREFILL_LEN / prefill_s,
        "launches": counts,
        "routed_assignments": drops["routed"],
        "dropped_assignments": drops["dropped"],
        "dropped_share": drops["dropped"] / drops["routed"],
        "logits_finite": finite,
        "peak_memory_gb": prefill_peak,
        "handoff": {"batch": hb, "prefill": hs, "decoded": 1,
                    "capacity_factor": nodrop.moe.capacity_factor,
                    "dropped": handoff_drops["dropped"], "bf16_seconds": handoff_s,
                    "bf16": {**handoff, "bound": PREFILL_REL_TOL,
                             "within_bound": handoff["max_rel_err"] <= PREFILL_REL_TOL,
                             "peak_memory_gb": handoff_peak},
                    "float32": {**handoff32, "layers": keep,
                                "tolerance": MOE_HANDOFF_F32_TOL},
                    "bf16_prefill_vs_float32_prefill": floor},
        "reduced": {"depth": f"{cfg.n_layers} of {get_config(arch).n_layers} layers",
                    "handoff": f"{hb} x {hs} + 1 tokens; float32 on the first {keep} "
                               f"layer(s)"},
    })
    if not finite:
        raise AssertionError(f"{arch} prefill: non-finite logits")
    if (handoff_drops["dropped"] or not (handoff["finite"] and handoff32["finite"])
            or handoff32["max_rel_err"] > MOE_HANDOFF_F32_TOL
            or not handoff["clear_argmax_agree"] or not handoff32["clear_argmax_agree"]):
        raise AssertionError(f"{arch}: decode after prefill disagrees with prefill over S + 1")
    if any(c["plain"] for c in counts.values()):
        raise AssertionError(f"{arch} prefill went around a kernel: {counts}")
    expect = {"rmsnorm": _norms_per_step(cfg), "flash_attention": attn,
              "decode_attention": 0, "ssd_scan": 0}
    for name, n in expect.items():
        if counts[name][name] != n:
            raise AssertionError(f"{arch} prefill: {counts[name]} {name} launches, expected {n}")
    if counts["flash_attention"]["tensor_core"] != attn:
        raise AssertionError(f"{arch} prefill: K6 off the tensor cores: "
                             f"{counts['flash_attention']}")
    return counts


# ---- the Mamba2 family: K7, serving and prefill -------------------------------


def _ssd_inputs(gen: torch.Generator, b: int, s: int, h: int, p: int, n: int, dtype):
    """x, dt (post-softplus), a (< 0), bm, cm on the card, scaled as
    ``tests/test_kernels.py`` scales them."""
    x = _randn(gen, (b, s, h, p), torch.float32).mul_(0.5).to(dtype)
    dt = torch.nn.functional.softplus(_randn(gen, (b, s, h), torch.float32))
    a = -torch.exp(_randn(gen, (h,), torch.float32) * 0.3)
    bm = _randn(gen, (b, s, n), torch.float32).mul_(0.5).to(dtype)
    cm = _randn(gen, (b, s, n), torch.float32).mul_(0.5).to(dtype)
    return x, dt, a, bm, cm


def _ssd_dims(cfg) -> tuple[int, int, int]:
    d_in = cfg.ssm.expand * cfg.d_model
    return d_in // cfg.ssm.head_dim, cfg.ssm.head_dim, cfg.ssm.state_dim


def phase_ssm_kernels(seed: int) -> dict[str, float]:
    """K7 against its plain version (at the model's chunk) at both models'
    prefill shapes, ragged lengths and a batch of 1, through strided
    slices of one conv output as the model hands them over; K6 and K5 at
    Zamba2's head width 80.  Returns the largest error per kernel."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 60)
    m2, z2 = (get_config(a) for a in SSM_ARCHS)
    hm, pm, nm = _ssd_dims(m2)
    hz, pz, nz = _ssd_dims(z2)
    chunk = m2.ssm.chunk
    atol, rtol = SSD_TOL
    worst = {"ssd_scan": 0.0, "decode_attention": 0.0, "flash_attention": 0.0}
    cases = []
    for dtype_name in ("float32", "bfloat16"):
        dt_ = getattr(torch, dtype_name)
        for label, (b, s, h, p, n) in (
            ("mamba2-130m prefill", (PREFILL_BATCH, PREFILL_LEN, hm, pm, nm)),
            ("zamba2-2.7b prefill", (PREFILL_BATCH, PREFILL_LEN, hz, pz, nz)),
            ("ragged S=200", (PREFILL_BATCH, 200, hm, pm, nm)),
            ("ragged S=2000", (PREFILL_BATCH, 2000, hz, pz, nz)),
            ("batch 1", (1, PREFILL_LEN, hm, pm, nm)),
            ("one token", (2, 1, hz, pz, nz)),
            *((f"ragged S={s}, {arch}", (2, s, h, p, n))
              for s in SSD_RAGGED
              for arch, (h, p, n) in ((SSM_ARCHS[0], (hm, pm, nm)),
                                      (SSM_ARCHS[1], (hz, pz, nz)))),
            *((f"P={p}, N={n}", (2, 130, 5, p, n))
              for p in ssk.HEAD_DIMS for n in ssk.STATE_DIMS),
        ):
            args = _ssd_inputs(gen, b, s, h, p, n, dt_)
            got = ssk.ssd_scan(*args, chunk=chunk)
            want = ssk.ssd_scan_plain(*args, chunk)
            errs = [float((g - w).abs().max()) for g, w in zip(got, want)]
            scales = [float(w.abs().max()) for w in want]
            ok = all(e <= atol + rtol * sc for e, sc in zip(errs, scales))
            cases.append({"kernel": "ssd_scan", "case": label, "shape": [b, s, h, p, n],
                          "dtype": dtype_name, "max_abs_err": max(errs),
                          "y_err": errs[0], "state_err": errs[1], "max_abs_y": scales[0],
                          "max_abs_state": scales[1], "ok": ok})
        # the model's layout: x, B and C are slices of one conv output
        b, s, h, p, n = 2, 300, hm, pm, nm
        conv = _randn(gen, (b, s, h * p + 2 * n), torch.float32).mul_(0.5).to(dt_)
        x = conv[..., : h * p].reshape(b, s, h, p)
        bm, cm = conv[..., h * p : h * p + n], conv[..., h * p + n :]
        _, dts, a, _, _ = _ssd_inputs(gen, b, s, h, p, n, dt_)
        got = ssk.ssd_scan(x, dts, a, bm, cm, chunk=chunk)
        want = ssk.ssd_scan_plain(x.contiguous(), dts, a, bm.contiguous(), cm.contiguous(),
                                  chunk)
        errs = [float((g - w).abs().max()) for g, w in zip(got, want)]
        scales = [float(w.abs().max()) for w in want]
        cases.append({"kernel": "ssd_scan", "case": "strided conv slices",
                      "shape": [b, s, h, p, n], "dtype": dtype_name,
                      "max_abs_err": max(errs), "y_err": errs[0], "state_err": errs[1],
                      "max_abs_y": scales[0], "max_abs_state": scales[1],
                      "ok": all(e <= atol + rtol * sc for e, sc in zip(errs, scales))})
        # the same one element past a 16-byte boundary, odd row strides
        conv = _randn(gen, (b, s, h * p + 2 * n + 3), torch.float32).mul_(0.5).to(dt_)
        x = conv[..., 1 : 1 + h * p].reshape(b, s, h, p)
        bm = conv[..., 1 + h * p : 1 + h * p + n]
        cm = conv[..., 1 + h * p + n : 1 + h * p + 2 * n]
        got = ssk.ssd_scan(x, dts, a, bm, cm, chunk=chunk)
        want = ssk.ssd_scan_plain(x.contiguous(), dts, a, bm.contiguous(), cm.contiguous(),
                                  chunk)
        errs = [float((g - w).abs().max()) for g, w in zip(got, want)]
        scales = [float(w.abs().max()) for w in want]
        cases.append({"kernel": "ssd_scan", "case": "conv slices off 16-byte alignment",
                      "shape": [b, s, h, p, n], "dtype": dtype_name,
                      "max_abs_err": max(errs), "y_err": errs[0], "state_err": errs[1],
                      "max_abs_y": scales[0], "max_abs_state": scales[1],
                      "ok": all(e <= atol + rtol * sc for e, sc in zip(errs, scales))})
        hd = z2.head_dim_
        for label, (b, nh, sl), causal in (
            ("zamba2 prefill", (PREFILL_BATCH, z2.n_heads, PREFILL_LEN), True),
            ("ragged S=2000", (2, z2.n_heads, 2000), True),
            ("ragged S=2000, not causal", (2, z2.n_heads, 2000), False),
        ):
            q = _randn(gen, (b, nh, sl, hd), dt_)
            k, v = _randn(gen, (b, nh, sl, hd), dt_), _randn(gen, (b, nh, sl, hd), dt_)
            err, ok = _model_err(fak.flash_attention(q, k, v, causal=causal),
                                 fak.flash_attention_plain(q, k, v, causal=causal),
                                 dtype_name)
            cases.append({"kernel": "flash_attention", "case": f"hd 80, {label}",
                          "shape": [b, nh, nh, sl, hd], "causal": causal,
                          "dtype": dtype_name, "max_abs_err": err, "ok": ok})
        b, sl, nh = 2, 500, z2.n_heads  # Zamba2's q, k, v as views of one row
        qkv = _randn(gen, (b, sl, 3 * nh * hd), dt_)
        q, k, v = (qkv[..., i * nh * hd : (i + 1) * nh * hd].reshape(b, sl, nh, hd)
                   .transpose(1, 2) for i in range(3))
        err, ok = _model_err(fak.flash_attention(q, k, v),
                             fak.flash_attention_plain(q.contiguous(), k.contiguous(),
                                                       v.contiguous()), dtype_name)
        cases.append({"kernel": "flash_attention", "case": "hd 80, strided (B, S, H, hd) views",
                      "shape": [b, nh, nh, sl, hd], "causal": True, "dtype": dtype_name,
                      "max_abs_err": err, "ok": ok})
        b, t = SERVE_SLOTS, SERVE_MAX_LEN
        chunk, splits = dak.split_plan(b, z2.n_kv_heads, t, _sms())
        q = _randn(gen, (b, z2.n_heads, hd), dt_)
        k = _randn(gen, (b, z2.n_kv_heads, t, hd), dt_)
        v = _randn(gen, (b, z2.n_kv_heads, t, hd), dt_)
        for label, pos in (
            ("random pos", torch.randint(0, t, (b,), generator=gen, device="cuda")),
            ("pos 0", torch.zeros(b, device="cuda")),
            ("pos T-1", torch.full((b,), t - 1, device="cuda")),
            ("pos past T", torch.tensor([t + 5, 7, 300, t - 1], device="cuda")),
            ("chunk and split boundaries",
             torch.tensor([chunk - 1, chunk, splits * chunk - 1, splits * chunk],
                          device="cuda")),
        ):
            pos = pos.to(torch.int32)
            err, ok = _model_err(dak.decode_attention(q, k, v, pos),
                                 dak.decode_attention_plain(q, k, v, pos), dtype_name)
            cases.append({"kernel": "decode_attention", "case": f"hd 80, {label}",
                          "shape": [b, z2.n_heads, z2.n_kv_heads, t, hd],
                          "dtype": dtype_name, "max_abs_err": err, "ok": ok})
    torch.cuda.synchronize()
    for c in cases:
        worst[c["kernel"]] = max(worst[c["kernel"]], c["max_abs_err"])
    emit({
        "phase": "ssm_kernels",
        "held": list(worst),
        "tolerance": {
            "ssd_scan": {"atol": atol, "rtol_of_max_abs": rtol, "plain_chunk": chunk},
            **{k: {"atol": a_, "rtol": r_} for k, (a_, r_) in MODEL_TOL.items()},
        },
        "cases": cases,
        "max_abs_err": worst,
    })
    bad = [c for c in cases if not c["ok"]]
    if bad:
        raise AssertionError(f"K7 / hd-80 kernels disagree with their plain versions: {bad}")
    return worst


def phase_ssm_prefill(arch: str, params, seed: int, cfg=None) -> dict:
    """``make_prefill_step`` on 4 x 2048 tokens (K7 once per Mamba2 layer,
    K6 once per use of the shared block, K4); then the first 1792 tokens
    prefilled and the other 256 decoded one step at a time, whose last
    logits are held against the 2048-token prefill's: in float32 (the
    same weights upcast) within ``SSM_CONT_F32_TOL``, and in bf16 with
    every clear argmax agreeing and the gap reported beside the bf16
    prefill's own distance from float32.  ``cfg``: a depth-cut config of
    ``arch``, the one ``params`` were made for."""
    cfg = cfg or get_config(arch)
    uses = _attn_per_step(cfg)
    gen = torch.Generator(device="cuda").manual_seed(seed + 80)
    toks = torch.randint(1, cfg.vocab, (PREFILL_BATCH, PREFILL_LEN), generator=gen,
                         device="cuda", dtype=torch.int32)
    step = make_prefill_step(cfg, max_len=SSM_PREFILL_MAX_LEN)
    step(params, {"tokens": toks[:, :128]})  # warm up
    torch.cuda.synchronize()
    _reset_model_counts()
    t0 = time.perf_counter()
    want, cache = step(params, {"tokens": toks})
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    counts = _model_counts()
    del cache
    t0 = time.perf_counter()
    got = _continue(params, cfg, toks)
    torch.cuda.synchronize()
    cont_s = time.perf_counter() - t0
    # the same weights in float32: the handoff without bf16 rounding
    cfg32 = cfg.scaled(dtype="float32")
    params32 = copy.deepcopy(params).float()
    want32, _ = prefill(params32, cfg32, {"tokens": toks})
    got32 = _continue(params32, cfg32, toks)
    del params32
    torch.cuda.empty_cache()
    got, want = got[:, 0].float(), want[:, 0].float()
    got32, want32 = got32[:, 0], want32[:, 0]
    scale, scale32 = float(want.abs().max()), float(want32.abs().max())
    rel = float((got - want).abs().max()) / scale
    rel32 = float((got32 - want32).abs().max()) / scale32
    floor = float((want - want32).abs().max()) / scale32
    top2 = want.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > SSM_CONT_REL_TOL * scale
    agree = got.argmax(-1) == want.argmax(-1)
    emit({
        "phase": "ssm_prefill",
        "arch": arch,
        "batch": PREFILL_BATCH,
        "prompt_len": PREFILL_LEN,
        "max_len": SSM_PREFILL_MAX_LEN,
        "prefill_s": prefill_s,
        "prefill_tokens_per_s": PREFILL_BATCH * PREFILL_LEN / prefill_s,
        "launches": counts,
        "continuation": f"prefill {SSM_CONT_PREFIX} + {PREFILL_LEN - SSM_CONT_PREFIX} "
                        f"decode steps vs prefill {PREFILL_LEN}",
        "continuation_s": cont_s,
        "max_abs_logit": scale,
        "max_rel_err": rel,
        "bf16_bound": SSM_CONT_REL_TOL,
        "bf16_within_bound": rel <= SSM_CONT_REL_TOL,
        "bf16_prefill_vs_float32_prefill": floor,
        "float32_max_rel_err": rel32,
        "float32_tolerance": SSM_CONT_F32_TOL,
        "argmax_agree": agree.tolist(),
        "argmax_gap_clear": clear.tolist(),
    })
    if rel32 > SSM_CONT_F32_TOL or not bool(agree[clear].all()):
        raise AssertionError(f"{arch}: prefill + decode disagrees with the prefill over "
                             f"{PREFILL_LEN} tokens")
    if any(c["plain"] for c in counts.values()):
        raise AssertionError(f"{arch} prefill went around a kernel: {counts}")
    expect = {"ssd_scan": cfg.n_layers, "flash_attention": uses,
              "rmsnorm": _norms_per_step(cfg), "decode_attention": 0}
    for name, n in expect.items():
        if counts[name][name] != n:
            raise AssertionError(f"{arch} prefill: {counts[name]} {name} launches, "
                                 f"expected {n}")
    if counts["flash_attention"]["tensor_core"] != uses:
        raise AssertionError(f"{arch} prefill: K6 off the tensor cores: "
                             f"{counts['flash_attention']}")
    if counts["ssd_scan"]["tensor_core"] != cfg.n_layers:
        raise AssertionError(f"{arch} prefill: K7 off the tensor cores: "
                             f"{counts['ssd_scan']}")
    return counts


def _continue(params, cfg, toks: torch.Tensor) -> torch.Tensor:
    """Last logits after prefilling the first SSM_CONT_PREFIX tokens of
    ``toks`` and decoding the rest one step at a time."""
    got, cache = prefill(params, cfg, {"tokens": toks[:, :SSM_CONT_PREFIX]},
                         max_len=toks.shape[1])
    for t in range(SSM_CONT_PREFIX, toks.shape[1]):
        got, cache = decode_step(params, cfg, toks[:, t : t + 1], cache)
    return got


def _by_name(device_us: dict[str, float], calls: int) -> dict[str, float]:
    """Device µs per call by kernel function name (namespace and template
    arguments dropped, entries of one name summed), and their total."""
    out: dict[str, float] = {}
    for key, us in device_us.items():
        found = re.search(r"(\w+_kernel)\b", key)
        name = found.group(1) if found else key[:60]
        out[name] = out.get(name, 0.0) + us / calls
    out["total"] = sum(device_us.values()) / calls
    return out


def _ssd_bound(b: int, s: int, h: int, p: int, n: int, elt: int) -> tuple[float, str]:
    """Bytes: x, B and C in the model dtype, dt and a in fp32 read once, y
    and the final state written once in fp32.  Operations: the kernel's
    chunked form at its 64-row tiles (the scores' and the intra-tile
    product's lower triangles, C.h^T and the state update), over the
    dense bf16 tensor-core rate (the inputs' type)."""
    nbytes = elt * (b * s * h * p + 2 * b * s * n) + 4 * (b * s * h + h) \
        + 4 * (b * s * h * p + b * h * p * n)
    tri = (SSD_TILE + 1) / 2
    flops = 2 * b * h * s * (tri * n + tri * p + 2 * p * n)
    return _bound(nbytes, flops, PEAK_BF16_FLOPS)


def phase_ssm_timings(seed: int) -> dict:
    """K7 at both models' prefill shapes and K6 at hd 80 (Zamba2's prefill
    shape), in bf16: device time per call under the profiler and CUDA
    events, beside their plain versions, SDPA for K6 (no single PyTorch
    call computes the SSD scan) and the bound."""
    F = torch.nn.functional
    gen = torch.Generator(device="cuda").manual_seed(seed + 90)
    bf16 = torch.bfloat16
    rows = {}
    for arch in SSM_ARCHS:
        cfg = get_config(arch)
        h, p, n = _ssd_dims(cfg)
        b, s = PREFILL_BATCH, PREFILL_LEN
        args = _ssd_inputs(gen, b, s, h, p, n, bf16)
        kernel = lambda: ssk.ssd_scan(*args, chunk=cfg.ssm.chunk)  # noqa: E731
        plain = lambda: ssk.ssd_scan_plain(*args, cfg.ssm.chunk)  # noqa: E731
        k1, p1, p2, k2 = (cuda_ms(f, 10) for f in (kernel, plain, plain, kernel))
        bound, by = _ssd_bound(b, s, h, p, n, 2)
        by_kernel = profile_device_us(lambda: [kernel() for _ in range(10)], cpu_ops=False)
        rows[f"ssd_scan {arch}"] = {
            "shape": [b, s, h, p, n], "kernel_ms": device_ms_per_call(kernel, 10),
            "plain_ms": device_ms_per_call(plain, 5), "library_ms": None,
            "kernel_event_ms": [k1, k2], "plain_event_ms": [p1, p2],
            "kernel_us_by_kernel": _by_name(by_kernel, 10),
            "bound_ms": bound, "bound_by": by,
        }
    z2 = get_config("zamba2-2.7b")
    b, hh, s, hd = PREFILL_BATCH, z2.n_heads, PREFILL_LEN, z2.head_dim_
    q = _randn(gen, (b, hh, s, hd), bf16)
    k, v = _randn(gen, (b, hh, s, hd), bf16), _randn(gen, (b, hh, s, hd), bf16)
    t = _time_three(
        lambda: fak.flash_attention(q, k, v, causal=True),
        lambda: fak.flash_attention_plain(q, k, v, causal=True),
        lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True),
        5,
    )
    pairs = b * hh * s * (s + 1) // 2
    bound, by = _bound(2 * 4 * b * hh * s * hd, 4 * pairs * hd, PEAK_BF16_FLOPS)
    rows["flash_attention hd 80"] = {"shape": [b, hh, hh, s, hd], "causal": True, **t,
                                     "bound_ms": bound, "bound_by": by}
    emit({"phase": "ssm_timings", "dtype": "bfloat16", "kernels": rows})
    return rows


def _free() -> None:
    """Release a served model's memory: phase_serve's engines hold their
    model in a reference cycle (the counting ``_decode`` wrapper), which
    only a full collection frees, and large imports (``torch.distributed.
    tensor``) make the interpreter's own full collections rarer."""
    gc.collect()
    torch.cuda.empty_cache()


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    faulthandler.dump_traceback_later(WATCHDOG_S)
    # host-only references run in one worker process beside the card's
    # phases; it is stopped however the run ends
    pool = multiprocessing.get_context("spawn").Pool(1)
    try:
        return run(args, pool)
    finally:
        faulthandler.cancel_dump_traceback_later()
        pool.terminate()
        pool.join()


def run(args: argparse.Namespace, pool) -> int:
    """Every phase in order (:func:`main` owns the host worker ``pool``)."""
    t_start = time.perf_counter()
    torch.cuda.set_device(0)
    dev = phase_device()
    jobs = main_path_trace(args.seed)
    host_wf = {o: pool.apply_async(host_wf_run, (main_path_jobs(jobs, o), o))
               for o in ("fifo", "ocwf-acc")}
    phase_build()
    worst = phase_kernels(args.seed)
    worst["wf_fused"] = phase_fused_kernel(args.seed)
    rd_worst = phase_rd_kernel(args.seed, jobs)
    bursts, launches, slot_runs = phase_main_path(args.seed, jobs, host_wf)
    rd_launches, rd_admitted = phase_rd_main_path(args.seed, jobs)
    seconds = {}
    t0 = time.perf_counter()
    plane = phase_control_plane(jobs, slot_runs)
    seconds["control_plane"] = time.perf_counter() - t0
    online = phase_faults_online(args.seed, jobs)
    seconds["faults_online"] = time.perf_counter() - t0 - sum(seconds.values())
    exact = phase_exact(jobs, plane, pool)
    seconds["exact"] = time.perf_counter() - t0 - sum(seconds.values())
    # the examples' CPU side runs in the (now idle) host worker meanwhile
    examples_cpu = pool.apply_async(examples_cpu_half)
    plane_serve = phase_plane_serve(args.seed, jobs)
    seconds["plane_serve"] = time.perf_counter() - t0 - sum(seconds.values())
    emit({"phase": "control_plane_phases", "seconds": seconds,
          "total_s": time.perf_counter() - t0})
    # this slice's phases: observability, the CSV replay, MoE routing (the
    # observed serve and contracts phases run later, timed into new_s)
    new_s = {}
    t0 = time.perf_counter()
    observed = phase_observed_main_path(jobs, slot_runs)
    new_s["observed_main_path"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    csv_replay = phase_csv_replay(args.seed)
    new_s["csv_replay"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    moe = phase_moe_balance(args.seed)
    new_s["moe_balance"] = time.perf_counter() - t0
    for extra in (plane, online, exact, plane_serve, observed, csv_replay, moe):
        launches["wf_fused"] += extra["launches"]["wf_fused"]
        rd_launches += extra["launches"]["rd_step"]
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 parity: full fp32
    torch.backends.cudnn.allow_tf32 = False
    model_worst = phase_model_kernels(args.seed)
    slice11_s = {}
    t0 = time.perf_counter()
    widths = phase_attention_widths(args.seed)
    slice11_s["attention_widths"] = time.perf_counter() - t0
    phase_serve_parity(args.seed)
    serve_counts, params = phase_serve(SERVE_ARCH, args.seed, SERVE_REPLICAS, SERVE_REQUESTS,
                                       SERVE_PROMPT, SERVE_NEW, "serve_main_path")
    phase_decode_profile(params, args.seed)
    prefill_counts = phase_prefill_path(params, args.seed)
    t0 = time.perf_counter()
    phase_observed_serve(params, args.seed)
    new_s["observed_serve"] = time.perf_counter() - t0
    del params
    _free()
    model_timed = phase_model_timings(args.seed)
    ssm_worst = phase_ssm_kernels(args.seed)
    ssm_timed = phase_ssm_timings(args.seed)
    phase_serve_parity(args.seed, SSM_ARCHS, "ssm_serve_parity", logit_tol=1e-4)
    ssm_counts = []
    for arch in SSM_ARCHS:
        cfg, reduced = get_config(arch), None
        if SSM_LAYERS[arch] is not None:
            cfg = cfg.scaled(n_layers=SSM_LAYERS[arch])
            reduced = {"depth": f"{cfg.n_layers} of {get_config(arch).n_layers} layers"}
        counts, params = phase_serve(arch, args.seed, SSM_REPLICAS[arch], SSM_REQUESTS,
                                     SSM_PROMPT, SSM_NEW, f"{cfg.block_pattern}_serve",
                                     cfg=cfg, reduced=reduced)
        phase_decode_profile(params, args.seed, arch, f"{arch}_decode_profile", cfg=cfg)
        ssm_counts += [counts, phase_ssm_prefill(arch, params, args.seed, cfg)]
        del params
        _free()
    # this slice: the MoE and MLA + MoE families at full width, depth cut
    moe_s: dict[str, float] = {}
    t0 = time.perf_counter()
    phase_serve_parity(args.seed, MOE_ARCHS, "moe_serve_parity", logit_tol=1e-4)
    moe_s["moe_serve_parity"] = time.perf_counter() - t0
    moe_counts = []
    for arch in MOE_ARCHS:
        t0 = time.perf_counter()
        cfg = get_config(arch).scaled(n_layers=MOE_LAYERS[arch], mtp_depth=0)
        replicas, n_req, prompt, n_new = MOE_SERVE[arch]
        reduced = {"depth": f"{cfg.n_layers} of {get_config(arch).n_layers} layers"
                   + (", no MTP block (serving never runs it)"
                      if get_config(arch).mtp_depth else "")}
        counts, params = phase_serve(arch, args.seed, replicas, n_req, prompt, n_new,
                                     f"{cfg.block_pattern}_serve", cfg=cfg, reduced=reduced)
        phase_decode_profile(params, args.seed, arch, f"{arch}_decode_profile", cfg=cfg)
        moe_counts += [counts, phase_moe_prefill(arch, params, cfg, args.seed)]
        del params
        _free()
        moe_s[arch] = time.perf_counter() - t0
    emit({"phase": "moe_phases", "seconds": moe_s, "total_s": sum(moe_s.values()),
          "budget_s": MOE_BUDGET_S})
    # this slice: LLaVA-NeXT-Mistral-7B at full width and depth, and training
    t0 = time.perf_counter()
    vlm_counts = phase_vlm_serve(args.seed)
    slice11_s["vlm_serve"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    train = phase_train(args.seed)
    slice11_s["train"] = time.perf_counter() - t0
    emit({"phase": "slice11_phases", "seconds": slice11_s, "total_s": sum(slice11_s.values()),
          "budget_s": SLICE11_BUDGET_S})
    # this slice: Whisper-medium (encdec) at full width and depth, served
    # and trained, and the port's train driver
    slice12_s = {}
    t0 = time.perf_counter()
    encdec_widths = phase_encdec_kernels(args.seed)
    slice12_s["encdec_kernels"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    encdec_counts = phase_encdec_serve(args.seed)
    slice12_s["encdec_serve"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    encdec_train_counts = phase_encdec_train(args.seed)
    slice12_s["encdec_train"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    launch_counts = phase_launch_train(args.seed)
    slice12_s["launch_train"] = time.perf_counter() - t0
    emit({"phase": "slice12_phases", "seconds": slice12_s, "total_s": sum(slice12_s.values()),
          "budget_s": SLICE12_BUDGET_S})
    # this slice: parallel/ (the sharded train step, the expert-parallel
    # MoE, int8 gradient compression) in a world of one NCCL rank
    parallel_counts = slice13_phases(args.seed, dev["nvidia_smi"])
    # this slice: the dry run's counts against real steps
    slice14_phases(args.seed, dev["nvidia_smi"])
    # this slice: the reference's four example entry points
    example_launches, example_counts = slice15_phases(dev["nvidia_smi"], examples_cpu)
    # this slice: the partitioned dense train and prefill steps
    partition_counts = slice16_phases(args.seed, dev["nvidia_smi"])
    # this slice: the partitioned dense decode step
    decode_counts, k5_partial = slice17_phases(args.seed, dev["nvidia_smi"])
    # this slice: the partitioned MoE and MLA + MoE steps
    moe_partition_counts = slice18_phases(args.seed, dev["nvidia_smi"])
    # this slice: the partitioned Mamba2 and Zamba2 steps
    ssm_partition_counts = slice19_phases(args.seed, dev["nvidia_smi"])
    for row in example_launches.values():
        launches["wf_fused"] += row["wf_fused"]
        rd_launches += row["rd_step"]
    timed = phase_timings(args.seed, bursts)
    rd_timed = phase_rd_timings(args.seed, rd_admitted)
    t0 = time.perf_counter()
    phase_contracts()
    new_s["contracts"] = time.perf_counter() - t0
    emit({"phase": "new_phases", "seconds": new_s, "total_s": sum(new_s.values()),
          "budget_s": 60})
    source = "src/repro_torch/kernels/csrc/waterlevel.cu"
    summary = []
    for name, replaces, shape in (
        ("waterlevel", "src/repro/kernels/waterlevel.py:329", (4096, 1)),
        ("waterlevel_batch", "src/repro/kernels/waterlevel.py:373", (4096, 8)),
    ):
        row = timed[shape]
        summary.append({
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": launches[name],
            "main_path": "none: the scheduler, batch and routing paths launch wf_fused "
            "(one launch per wf_torch call); K1/K2 run in the kernels and timings phases",
            "max_abs_err": worst[name],
            "ms": row["kernel_ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": None,  # no single PyTorch call computes this function
        })
    # the fused water-filling kernel: the scheduler's fifo and ocwf-acc
    # runs, the batch path, the control-plane phases (added to launches in
    # main) and the two wf_torch-routed serve pools
    pooled = sum(c["waterlevel"]["wf_groups"]
                 for c in (serve_counts, *ssm_counts[::2], *moe_counts[::2]))
    single, chain = timed["fused single"], timed["fused chain"]
    summary.append({
        "name": "wf_fused",
        "route": "cuda",
        "source": source,
        "replaces": "src/repro/kernels/waterlevel.py:329",
        "contract": "the K-group water-filling scan (wf_groups) or the B-job eq. 2 "
        "chain (wf_chain) in one launch, on the K1 row step; ms is per single-job "
        "call on the main path",
        "launches": launches["wf_fused"] + pooled,
        "group_steps": launches["wf_group_steps"],
        "max_abs_err": worst["wf_fused"],
        "ms": single["kernel_ms"],
        "plain_ms": single["plain_ms"],
        "bound_ms": single["bound_ms"],
        "bound_by": single["bound_by"],
        "library_ms": None,  # no single PyTorch call computes this function
        "also": {"at": "chained bursts", "ms": chain["kernel_ms"],
                 "plain_ms": chain["plain_ms"], "bound_ms": chain["bound_ms"],
                 "us_per_group_step": chain["kernel_us_per_group_step"]},
    })
    summary.append({
        "name": "rd_step",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rd_step.cu",
        "replaces": "src/repro/kernels/rd.py:194",
        "contract": "one iteration of device RD's deletion or dedup loop per "
        "launch (target pick, strip sort and walk, re-homing, deltas) on the "
        "RDState buffers, in place",
        "launches": rd_launches,
        "max_abs_err": rd_worst,
        "ms": rd_timed["kernel_ms"],
        "plain_ms": rd_timed["plain_ms"],
        "bound_ms": rd_timed["bound_ms"],
        "bound_by": rd_timed["bound_by"],
        # no single PyTorch call computes an RD iteration
        "library_ms": None,
    })
    # launches over every main path: the dense serve and prefill paths,
    # then each SSM model's serve and prefill paths
    paths = [serve_counts, prefill_counts, *ssm_counts, plane_serve["counts"], *moe_counts,
             vlm_counts, train["counts"], encdec_counts, encdec_train_counts, launch_counts,
             parallel_counts, *example_counts, partition_counts, decode_counts,
             moe_partition_counts, ssm_partition_counts]
    worst_model = {k: max(v, ssm_worst.get(k, 0.0), widths["max_abs_err"].get(k, 0.0),
                          encdec_widths["max_abs_err"].get(k, 0.0))
                   for k, v in model_worst.items()}
    worst_model["ssd_scan"] = ssm_worst["ssd_scan"]
    # beside each row's main timing, the other shapes that rank the
    # kernels: K4 at prefill rows (where it loses to F.rms_norm), K5 at the
    # decode profile's 301 keys, K6 at Zamba2's head width 80
    also = {
        "rmsnorm": ("prefill rows", model_timed["rmsnorm prefill"]),
        "decode_attention": ("301 keys", model_timed["decode_attention 301 keys"]),
        "flash_attention": ("hd 80", ssm_timed["flash_attention hd 80"]),
        "ssd_scan": ("zamba2-2.7b prefill", ssm_timed["ssd_scan zamba2-2.7b"]),
    }
    k6 = sum(c["flash_attention"]["flash_attention"] for c in paths)
    k6_tc = sum(c["flash_attention"]["tensor_core"] for c in paths)
    k7 = sum(c["ssd_scan"]["ssd_scan"] for c in paths)
    k7_tc = sum(c["ssd_scan"]["tensor_core"] for c in paths)
    design = {
        "decode_attention": {"split-KV, merged in the same launch": "float32 and bfloat16"},
        "flash_attention": {"tensor cores (wgmma + TMA)": f"bfloat16: {k6_tc} launches",
                            "CUDA cores": f"float32: {k6 - k6_tc} launches"},
        "ssd_scan": {"tensor cores (mma.sync; states per sequence and head, y chunk-parallel)":
                     f"bfloat16: {k7_tc} calls",
                     "CUDA cores (a block per sequence and head)":
                     f"float32: {k7 - k7_tc} calls"},
    }
    for name, replaces, row in (
        ("rmsnorm", "src/repro/kernels/rmsnorm.py:40", model_timed["rmsnorm decode"]),
        ("decode_attention", "src/repro/kernels/decode_attention.py:67",
         model_timed["decode_attention"]),
        ("flash_attention", "src/repro/kernels/flash_attention.py:91",
         model_timed["flash_attention"]),
        ("ssd_scan", "src/repro/kernels/ssd_scan.py:80", ssm_timed["ssd_scan mamba2-130m"]),
    ):
        entry = {
            "name": name,
            "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": replaces,
            "launches": sum(c[name][name] for c in paths),
            "max_abs_err": worst_model[name],
            "ms": row["kernel_ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "shape": row["shape"],
        }
        if name in design:
            entry["routes"] = design[name]
        if name in also:
            label, other = also[name]
            entry["also"] = {"at": label, "shape": other["shape"], "ms": other["kernel_ms"],
                             "plain_ms": other["plain_ms"], "bound_ms": other["bound_ms"],
                             "library_ms": other["library_ms"]}
        if name == "decode_attention":  # Qwen3-MoE's group of 16, two slices
            g16 = model_timed["decode_attention group 16"]
            entry["group_16"] = {"shape": g16["shape"], "ms": g16["kernel_ms"],
                                 "plain_ms": g16["plain_ms"], "bound_ms": g16["bound_ms"],
                                 "library_ms": g16["library_ms"], "slices": g16["slices"]}
        if name in ("decode_attention", "flash_attention"):
            # past the earlier ceilings, and at Whisper-medium's shapes
            for key, source in (("widths", widths), ("whisper", encdec_widths)):
                entry[key] = {
                    label[len(name) + 1:]: {"shape": row["shape"], "ms": row["kernel_ms"],
                                            "plain_ms": row["plain_ms"],
                                            "bound_ms": row["bound_ms"],
                                            "library_ms": row["library_ms"]}
                    for label, row in source["timed"].items() if label.startswith(name)}
        summary.append(entry)
    # K5's partial mode: the partitioned decode's attention over a rank's
    # shard, timed at Qwen3-32B decode_32k's block
    timed = k5_partial["timed"]
    summary.append({
        "name": "decode_attention_partial",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:67",
        "contract": "K5 over a cache shard at shard-local positions: fp32 out and each "
        "head's log-sum-exp, combined across the model axis",
        "launches": sum(c["decode_attention"].get("decode_attention_partial", 0)
                        for c in paths),
        "max_abs_err": k5_partial["max_abs_err"],
        "ms": timed["kernel_ms"],
        "plain_ms": timed["plain_ms"],
        "bound_ms": timed["bound_ms"],
        "bound_by": timed["bound_by"],
        "library_ms": timed["library_ms"],
        "shape": timed["shape"],
        "whole_mode_ms": timed["whole_mode_ms"],
    })
    emit({"phase": "wall", "seconds": time.perf_counter() - t_start})
    emit({"kernels": summary})
    print(dev["nvidia_smi"], flush=True)
    emit({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    })
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
