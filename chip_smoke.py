#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``horovod_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which must pass (nothing is caught; any failure exits
non-zero):

0. the card (``nvidia-smi``), torch and nvcc versions;
1. build the CUDA kernels from ``horovod_tpu_torch/ops/csrc`` with nvcc (one
   per source, in parallel), and disassemble the library: every
   instantiation of the tensor-core forward, dQ and dK/dV kernels (five
   head-dim widths; the forward's bf16 q/k/v with two output types and fp32
   q/k/v; dQ's and dK/dV's bf16 q/k/v with a bf16 or fp32 dO, and fp32
   q/k/v) must hold ``HGMMA`` instructions;
2. hold each kernel (flash forward, dQ, dK/dV) against its plain PyTorch
   version (fp32 sums, the kernels' bf16 rounding points) on the same
   inputs, at the flagship shape (B 8, S 1024, H 16, D 64, bf16, causal), at
   two ragged ones (S 1000, non-causal, nonzero dlse: D 128 bf16, and D 32
   fp32, the latter also on the lse route), at the flagship's attention in
   fp32 (B 8, S 1024, H 16, D 64, causal), at the ring hop's shard shape
   (B 8, S 1024, H 16, D 64, bf16) in the variants a ring hop runs
   (``flash_attention_lse``: fp32 output, fp32 dO split into bf16 planes by
   the split kernel, nonzero dlse), causal (the self-block) and not (the
   other hops), at an engine rank's rows of the flagship (B 4, S 1024, H
   16, D 64, bf16, causal), at an elastic rank's after the shrink (B 3),
   and at head dims 96 and 256 (B 2, S 1000, H 8,
   dlse, bf16) on both routes.  fp32 q/k/v reach the forward, dQ and dK/dV
   as three bf16 planes each (the split of q/k/v, and of dO); every split
   must match its plain version bit for bit;
3. inside one ``hvd.init()`` (a one-rank NCCL group), first the ResNet-50
   slice: ``resnet50_config()`` at full width and depth (blocks 3, 4, 6, 3,
   width 64, 1000 classes, bf16), batch 32 of 224x224 images from a fixed
   seed, SGD(0.01, momentum 0.9), through ``make_resnet_train_step_hvd``
   with ``mesh=make_mesh(), axis=("dp",)``, whose step-0 loss must be the
   no-mesh step's bit for bit.
   Five steps, the first beside an fp32 twin from the same seed (step-0
   loss, every gradient and the stem batch norm's statistics against it),
   falling and finite losses, no flash kernel launched, three steps with
   ``Compression.fp16``, then ten timed steps.  Then the flagship
   transformer at full width and depth (vocab 32768, d_model 1024, 8 layers,
   16 heads, d_ff 4096, seq 1024, batch 8, bf16, flash attention, remat)
   with weights from a fixed seed, five training steps through
   ``make_transformer_train_step(cfg, mesh=make_mesh())``
   (``DistributedOptimizer`` over AdamW, built with
   ``HVD_NONFINITE_POLICY=skip`` set, which must not arm its guard), whose
   step-0 loss must be, bit for bit, the loss of the model built without a
   mesh.
   A twin with dense attention starts from the same weights and takes
   the same steps.  Checks: finite losses, 16 forward, 8 dQ and 8 dK/dV
   launches per step, the first step's gradients and every step's loss
   against the twin's, and the first step's loss against the same model
   with its attention through the plain forward (with and without its bf16
   rounding of P).  Then ten steps alone are timed.  Then the same
   flagship with the Switch MoE FFN (8 experts, capacity factor 1.25;
   0.87 G parameters): five steps beside a dense-attention twin (step-0
   loss, and the gradients outside the experts, against the twin's; the
   experts' gradients and the tokens the twin routes elsewhere reported),
   falling finite losses, 16 forward, 8 dQ and 8 dK/dV launches per step,
   each layer's dropped share and aux loss, ten timed steps.  Then the
   pipelined flagship (``make_pipeline_train_step`` with four stages of
   two layers and four microbatches of two rows, every stage in this
   process through ``loopback_pipeline``) on batches drawn through the
   input pipeline (``ArrayDataset``, ``ShardedSampler``, ``batches``,
   ``prefetch_to_device``; the first batch bit for bit the plain
   iteration's): three steps beside the unpipelined flagship step from the
   same weights (step-0 loss and every gradient, later losses), falling
   finite losses, 64 forward, 32 dQ and 32 dK/dV launches a step; a
   verified checkpoint after step 3 resumed into a state from another
   seed, whose step 4 equals the original's bit for bit, and a corrupted
   second checkpoint that ``restore_verified`` falls back past; five timed
   steps.  Then one step of each is profiled, then one ResNet-50 step,
   five MNIST steps (batch 64, Adam) must give finite, falling losses, and
   the non-finite gradient guard runs on the card (``skip`` leaves
   parameters and AdamW state bit for bit, ``zero`` equals the step with
   the entry zeroed, ``off`` adds no collective).  ZeRO-1 at one rank
   (``zero1=True`` through ``make_mesh()``) logs the JAX package's "no dp
   axis > 1" warning and its first two flagship steps equal
   ``zero1=False``'s bit for bit.  Adasum over four virtual ranks'
   step-0 flagship gradients (``adasum_loopback``, fp32) agrees with the
   float64 oracle within ADASUM_TOL.  Last, one flagship step in fp32
   (``compute_dtype`` float32, the same widths) beside a dense-attention
   fp32 twin from the same seed: its step-0 loss and gradients against the
   twin's, and its launches of the fp32 kernels (16 forwards and q/k/v
   splits, 8 dQ, dK/dV and dO splits).  Then the replica audit:
   ``fingerprint`` over the flagship's training state after one step (the
   parameters and AdamW's moments, 2.0 GB) timed, and ``audit_replicas`` at
   one rank must return its folded digest;
4. sequence parallelism at the flagship's width: ring and Ulysses
   attention of four virtual ranks (``ring_attention.loopback_attention``,
   the gang's schedule in one process) over a global sequence of 4 x 1024
   (B 8, H 16, D 64, bf16), causal and not, against ``flash_attention`` over
   the whole sequence: the output and dQ, dK, dV (the same dO) within
   SP_TOL, and each ring run's launches by kernel variant (per virtual rank
   one causal and three other hops' forward, dQ and dK/dV, all run, and one
   dO split per hop); then one causal ring layer's device time per virtual
   rank under ``torch.profiler``, with the share of its backward kernels
   (the fp32-dO dQ and dK/dV and the split);
5. serving: the flagship (bf16, weights from seed 0) in a ``DecodeEngine``
   of 8 slots over a cache of 1024 positions, behind ``Scheduler`` and
   ``FrontDoor`` on 127.0.0.1, stepped by one loop thread in the order
   of the JAX package's serving loop while 16 client threads post
   ``/generate`` at once (prompts of 32-512 tokens, 64-256 new tokens, from
   a seed).  Every reply must be 200 with its tokens, and they must equal
   ``generate`` on each prompt alone; a request decoded beside seven
   neighbours must give the logits and token it gives alone in the engine,
   at every step, bit for bit; ``prefill_request``'s logits are held to the
   last position of ``apply`` with dense attention.  Prints TTFT, the
   decode step at eight live slots, one profiled decode step, prefill
   times, the KV cache's bytes and the peak memory.  The telemetry
   registry is on: ``hvd_serve_requests_total{status="ok"}`` must count
   the 16 requests, and ``Scheduler.stats()`` gives TTFT's p50 and p99
   from its histogram beside the host clock's.  Serving runs no
   flash kernel (its attention is dense), so it adds no entry to the
   kernels JSON;
6. the eager engine: this script starts the port's ``RendezvousServer``
   and two ranks of itself (``--engine-rank R``), both on cuda:0 (NCCL
   refuses two ranks on one card, so ``hvd.init(device=..., backend=
   "gloo")``, and the gradients go through the engine, not the group).
   Each makes the flagship from its own seed, ``broadcast_parameters``
   makes rank 1's rank 0's (bit for bit, by digest), and each takes three
   steps on its four of the eight rows of batches from seed 7: forward and
   backward through the flash kernels (48 / 24 / 24 launches a rank), one
   ``allreduce_async(grad, name=..., op=Average)`` per parameter, then
   ``synchronize`` and AdamW(1e-3, wd 0.01).  Held against
   ``make_transformer_train_step`` in this process on all eight rows from
   the same weights: the step-0 loss (the ranks' mean), each averaged
   step-0 gradient and each parameter after the steps (ENGINE_*_TOL); the
   ranks' parameters equal bit for bit; steps 2-3 served from the response
   cache (every tensor a hit); every fused response within the 64 MiB
   threshold; bf16 and fp32 card tensors through the engine's allreduce,
   allgather and broadcast back on cuda:0 with their CPU copies' bits;
   the two ranks' pair on the shm ring (they share the host).  Prints the
   step, enqueue and ``synchronize`` times, gradient bytes, fused
   responses, effective GB/s, cache hits, flash launches and each rank's
   link media.  Then the telemetry phase (see TEL_STEPS): the same two
   ranks for TEL_STEPS steps with the autotuner, the metrics (debug
   servers, flushers, rank 0's gang fold), the trace and the flight
   recorder on; the same gradient and parameter checks, and: the autotune
   log ends in its ``final`` row, a broadcast changed the knobs mid-run,
   the tuner settled two steps before the last and every rank's knobs are
   the settled ones; rank 0's ``/gang/metrics.json`` has no stale rank and
   its ``hvd_collectives_total`` of the gradients' fp32 allreduces equals
   the sum of the ranks' own snapshots and the gradients x steps x ranks;
   ``hvd_ring_hop_seconds`` has samples; both trace files parse, rank 1's
   has clock records and the same seq names the same collective on both,
   and the port's ``hvd_trace analyze_dir`` over them names the phases
   these checks read; no recorder dump.  Prints each rank's per-step span sums (negotiate,
   pack, hop recv, reduce and send wait, unpack, callback) beside its
   ``synchronize`` time, and the step medians against the engine
   phase's;
7. the engine's data plane: four ranks of this script
   (``--dataplane-rank R``) on cuda:0 as two virtual nodes of two, with
   the hierarchical allreduce and allgather, the recovery ladder and the
   timeline on, node 1 under ``HVD_SHM_DISABLE`` (see DP_RANKS): seeded
   card tensors at the flagship's widths through allreduce, a ragged
   allgather and broadcasts, against every rank's inputs rebuilt from the
   seeds, then again under fault plans with the first pass's bits; rank
   0's timeline parsed and checked.  Prints the media, each pass's time
   and GB/s and the ladder's retries and failovers;
8. the engine's self-healing control plane (``--liveness-rank R``, see
   LV_LAYERS): the flagship at full width and two layers, each rank on
   two rows, one ``allreduce_async(Average)`` per gradient.  Gang A, four
   ranks as two nodes of two with heartbeats, a 10 s deadline and the
   control tree: rank 2 (host 1's sub-coordinator) killed after step 1,
   rank 3 re-parented (``SUBCOORD_REPARENT``), step 2 over the survivors
   and held against their gradients recomputed here, step 3's submission
   raising ``RanksFailedError([2])``.  Gang B, three ranks on shm with the
   deadline: rank 2 stalled at step 1, ``CollectiveTimeoutError([2])`` on
   both survivors within twice the deadline, ``COLLECTIVE_ABORT``, the
   retained batch bit for bit, no shm segment left.  The flight recorder
   and the metrics' flusher are on in both: gang A's survivors each dump
   (``ranks_failed``) and the root counts one eviction; gang B's survivors
   dump ``collective_timeout``, the root's verdict note names rank 2 and
   it pulled rank 2's ring; the port's ``hvd_postmortem`` over each
   gang's dumps names the killed and the stalled rank as the first cause.
   Then phase 6 again with those knobs on.  Prints the step medians, kill to eviction and
   stall to error.  The ranks' flash kernels run at B 2, the pipelined
   microbatch's shape, which phase 2 checks;
9. the kernel checks of phase 2 again, and the times of the kernel, the
   plain version and PyTorch's ``scaled_dot_product_attention`` as a
   yardstick (forward alone for the forward, backward alone for dQ and
   dK/dV; the port never calls it), each as its kernels' device time per
   call under ``torch.profiler``, and the kernel also between CUDA events,
   which counts the host's gaps.  This comes after the slice, so that the
   steps are timed before any profiler has run;
10. elastic training (``--elastic-rank R``, see EL_ROWS; it runs after the
   liveness phase and its rerun, before 9): the flagship's gradient gang
   under ``@hvd.elastic.run`` with ``TorchState(model, optimizer,
   step=0)``, each step's six rows from seed 7 re-partitioned over the
   gang by a reset callback.  E1, at full depth: three ranks, rank 0 (the
   hub) killed after the first uncommitted step; the survivors re-form at
   epoch 1 as two (old rank 1 leads), roll back to the commit (digests
   equal the commit's), re-sync and finish; one failover and one re-form
   counted, ``ELASTIC_REFORM`` and ``LEADER_FAILOVER`` on the new rank
   0's timeline.  E2, at LV_LAYERS layers on the shm ring with the 10 s
   deadline: rank 2 stalled at step 1, ``CollectiveTimeoutError([2])`` on
   both survivors, the re-form, the aborted batch replayed (bit for bit
   the survivors' retained inputs averaged as the engine averages two
   ranks, the inputs recomputed here from the step-1 weights and the
   rows), no shm segment left.  E3, at LV_LAYERS layers: a joiner started
   after step 1 grows the gang from two to three at the next commit, its
   synced state rank 0's by digest.  Every gang: the survivors' final
   parameters bit for bit equal and within EL_PARAM_TOL[gang] of the
   one-process trajectory, each step's averaged gradients against the
   one-process gradient at the ranks' parameters.  Prints, beside the
   card, each survivor's time from the failure to the first step of the
   new epoch (detection, re-form, ``state.sync()`` with its bytes and
   GB/s, replay, the first step) and the step medians before and after;
11. the serving gang (``--serve-gang-rank``, see SG_RANKS; right after the
   serve phase): ``python -m horovod_tpu_torch.runner.run -np 3 --min-np 2
   --kv-standbys 1 --serve-max-batch 8`` starts three ranks of this
   script, each a ``ServingLoop`` over the flagship (seed 0, bf16, 8
   slots, cache 1024) on cuda:0 with no process group.  A: the serve
   phase's 16 requests at once, half through the followers' doors (which
   forward), every reply 200 with ``attempts == 1``.  B: eight of them
   under ids, rank 0 SIGKILLed once rank 1's slot table is full, the
   clients re-POSTing to rank 1's door: every reply 200 with ``attempts >
   1``, ``LEADER_FAILOVER`` naming rank 0 on rank 1's timeline, the
   survivors DONE and the launcher's exit 0 (two workers finished).  Every
   token of A and B equals, bit for bit, ``generate``'s on its prompt
   alone (the serve phase's oracle, which its ``DecodeEngine`` matched).
   Prints, beside the card, TTFT, the lockstep step (the leader's
   ``hvd_serve_token_latency_seconds``) against the one-process decode
   step, the confirm allreduce a step, the failover by part (detection,
   re-form, the engine rebuilt, replay to the first token) and each
   rank's peak memory.  Serving runs no flash kernel.  Then the tp serving
   gang (see SG_TP): ``-np 2 --min-np 1 --collective-timeout 20``, each
   rank a ``ServingLoop(mesh={"tp": 2})`` on cuda:0 over a gloo group the
   loop forms (the ranks share the card), holding its half of the heads,
   d_ff and vocabulary of the flagship at its full width and two layers
   (see SG_TP_LAYERS).
   A: the same 16 requests, every reply 200 with ``attempts == 1`` and
   its tokens, bit for bit, ``DecodeEngine``'s at tp 2 on its prompt
   alone, which the two ranks compute once their loop stopped.  B: both
   serve again, eight requests, rank 1 SIGKILLed once every slot is live:
   rank 0 re-forms alone, its engine at tp 1 (the ``serve.engine`` span
   says so), and replays them; every reply ``attempts > 1`` and bit for
   bit ``DecodeEngine``'s alone at tp 1.  Prints, beside the card and
   all at two layers, the lockstep step at tp 2 against the loop's at tp
   1 (B's survivor) and ``DecodeEngine``'s step alone at tp 1 and at tp
   2, the tp collectives' share of a step, and the failover by part.
   Then the control plane's scale harness (``ctrl_sim.run_curve`` at 8,
   64 and 256 in-process ranks, star and tree) on the card machine's host,
   with its CPU count;
12. the torch-api phase (``--torch-api-rank R``, see TA_PARAM_TOL; right
   after phase 6's first run): phase 6's two ranks train the flagship
   through the classic front-end, ``import horovod_tpu_torch.torch as
   hvd``.  Rank 0 from seed 0 and rank 1 from seed 1, made rank 0's bit
   for bit (parameters and AdamW state, by digest) by
   ``broadcast_parameters`` and ``broadcast_optimizer_state``; a
   hook-driven ``DistributedOptimizer`` over ``torch.optim.AdamW``, the
   allreduces fired during ``backward()``, three steps on four rows a rank,
   against a one-process twin; one step of ``backward_passes_per_step=2``;
   the Adasum delta optimizer at two layers against a float64 oracle; the
   gradients' ``grouped_allreduce`` under ``torch.compile(fullgraph=True)``
   (``ops/bridge.py``'s custom ops) bit for bit the eager one's, with no
   graph break.  Prints, beside the card, the step median against phase
   6's, the end of ``backward()`` to the end of ``step()``, kernel and
   flash launches a step (one profiled step) and the compiled reduction's
   ms against the eager one's;
13. the native phase (``--engine-rank R`` with the default core, see
   NATIVE_ROUTES; right after phase 12): the C++ core and the dispatcher
   ops built from ``horovod_tpu_torch/csrc/`` on a thread beside the
   kernels' nvcc at the start (the g++ version, the build seconds and
   paths printed here), then phase 6's two ranks with
   ``HVD_TPU_CORE`` unset: both must run ``NativeEngine`` with no
   fallback reason, train the flagship three steps through
   ``allreduce_async`` per parameter within phase 6's bounds, end with
   equal parameters bit for bit, and reduce their step-0 gradients three
   ways (the numpy route, ``torch.ops.hvd.allreduce_``,
   ``hvd::grouped_allreduce`` under ``torch.compile(fullgraph=True)``) to
   the same bits, with no graph break.  Prints, beside the card, the
   step, enqueue and ``synchronize`` medians against phase 6's (the
   Python engine, same call), and each route's time.  Every other phase
   that spawns ranks pins ``HVD_TPU_CORE=py``: their subjects (shm rings,
   the ladder, liveness, telemetry spans, the recorder, elastic, serving,
   the front-end's fusion knob) are the Python engine's;
14. the estimator phase (see EST_PARAM_TOL; after phase 10):
   ``horovod_tpu_torch.spark.TorchEstimator.fit`` through the port's
   launcher (``LocalBackend(2, device="cuda:0")``: two launched ranks of
   ``runner/run_task.py`` sharing the card, the eager engine on its
   default core, no process group) on ``tests/test_spark.py``'s model and
   data (a ``Linear(6, 1)`` from seed 0 on 256 rows of a linear teacher,
   SGD at 0.05, batch 32, four epochs, parquet shards in a local store),
   and, at the same time, the same fit with ``device="cpu"``.  Each
   rank's loss notes the device its inputs lie on; the card's ranks must
   note cuda:0 only and the CPU's cpu only; the card's loss history must
   fall to under half its first epoch's, and its fitted weights lie
   within EST_PARAM_TOL of the CPU fit's.  Prints both fits' wall times
   and the gap beside the card.  TensorFlow, Keras, MXNet and Spark are
   not on the card's machine, so their front-ends have no phase.
15. the examples phase (see EX_LM_ARGS; after phase 14): three scripts of
   ``examples/torch_port/``, each its own process on cuda:0 through
   ``hvdrun-torch -np 1`` (``python -m horovod_tpu_torch.runner.run``)
   under a time limit: ``transformer_lm.py`` at the flagship's full width
   (bf16, causal flash attention, a one-rank NCCL group) for EX_LM_STEPS
   steps, ``pytorch_synthetic_benchmark.py`` (the port's ResNet-50 at
   batch 32, a short schedule) and ``serve_lm.py --selftest`` on the
   flagship's width in bf16 (seeded prompts whose replies must differ,
   every reply held to ``DecodeEngine`` alone).  Each must exit 0, print only finite
   losses and name cuda:0 and the card as its device; the LM must launch
   the flash forward, dQ and dK/dV kernels (its own count, printed).
   Prints each script's wall time, the LM's step median and tokens/s and
   the benchmark's Img/sec, each beside the card's name and power limit.
   ``python3 chip_smoke.py --examples-only`` runs the build and this phase
   alone.

Phases 0-5 run in this order, then the control plane's curve (phase 11's
``ctrl_sim``) and phase 14, which time the host, alone.  The gang phases
then run in three lanes at once, each lane a thread of this process that
runs its phases in order: the engine lane (phase 6, 12, 13, 6 with the
telemetry knobs, 6 with LV_KNOBS), the fault lane (7, 8, 10) and the
serving lane (11's gangs, 15).  Their ranks share the card and the host's
cores with the other lanes' ranks, so their wall and step times are those
of a loaded host; the references they train in this process take turns
(``_INPROC``).  Phase 9's kernel times are taken after every lane ended.

The ``kernels`` JSON lists the flagship's three kernels, the same three
with their launches in the MoE flagship's run (``flash_<kernel>_moe``: its
attention is the flagship's), the same three at the pipelined flagship's
microbatch (B 2, S 1024, H 16, D 64, bf16, causal; checked in phase 2)
with their launches in its run (``flash_<kernel>_pp``), the same three at
an elastic rank's rows after the shrink (B 3; checked in phase 2) with
their launches in the elastic gangs' steps (``flash_<kernel>_elastic``),
the same three at an engine rank's rows (B 4) with their launches in the
torch-api phase's steps on rank 0 (``flash_<kernel>_torch_api``),
the ring hop's six variants
(``flash_<kernel>_ring_self`` and ``_ring_hop``) and the ring hop's dO
split (``flash_split_do``), then the fp32 kernels
(``flash_<kernel>_fp32``, ``flash_split_qkv_fp32``,
``flash_split_do_fp32``) timed at the flagship's attention in fp32, with
their launches in the main path's run (the ring's: the causal ring run of
phase 4; the fp32 kernels': the fp32 step).  The last three lines are
the ``kernels`` JSON, the card's name and power limit, and
``{"ok": true, "device": {...}}``.  Exits non-zero, printing no
result, where torch finds no CUDA device.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import statistics
import subprocess
import sys
import threading
import time

# Peak rates for the bound: (bf16 dense tensor-core FLOP/s, tf32 dense
# tensor-core FLOP/s, fp32 FLOP/s outside the tensor cores, device-memory
# bytes/s), from NVIDIA's "H100 Tensor Core GPU" data sheet (dense rates,
# without sparsity, at the full power limit), keyed by a part of the card's
# name as torch reports it.  A card that matches no key stops the run
# rather than borrow another's peaks.
PEAKS = {
    "H100 80GB HBM3": (989e12, 494.7e12, 67e12, 3.35e12),  # SXM5
    "H100 SXM": (989e12, 494.7e12, 67e12, 3.35e12),
    "H100 PCIe": (756e12, 378e12, 51e12, 2.0e12),
    "H100 NVL": (835e12, 417.5e12, 60e12, 3.9e12),
}
# Every kernel of the port, and its C entry points.
SOURCE = "horovod_tpu_torch/ops/csrc/flash_wgmma.cu"
# Kernels that must run on the tensor cores, by their name in the library.
WGMMA_KERNELS = ("fwd_wgmma_kernel", "dkv_wgmma_kernel", "dq_wgmma_kernel")
# cuDNN's convolution and cuBLAS's matrix-product kernels, by name.
CONV_KERNELS = r"xmma|cutlass|nvjet|gemm|cudnn|conv"
REPLACES = {"fwd": "horovod_tpu/ops/pallas_attention.py:77",
            "dq": "horovod_tpu/ops/pallas_attention.py:174",
            "dkv": "horovod_tpu/ops/pallas_attention.py:215",
            # the fp32 dO that _dq_kernel and _dkv_kernel read
            "split": "horovod_tpu/ops/pallas_attention.py:190",
            # the fp32 q, k and v that _fwd_kernel (and _dkv_kernel) read
            "split_qkv": "horovod_tpu/ops/pallas_attention.py:98"}
# Each element of a kernel output against its plain version on the same
# inputs: |got - want| <= rtol |want| + atol rms(want) + slack, as (rtol,
# atol), by the output's dtype.  bf16: rtol is one bf16 ulp at the bottom
# of a binade (2^-7): both sides round their fp32 result once, so equal
# sums end at most one ulp apart; fp32: the order of the sums and the
# fp32 kernels' three-plane products (each term within about 2^-16 of its
# fp32 value; tests/test_torch_flash_fp32.py emulates them).  slack
# (fa.rounding_slack) covers the bf16 intermediates (P, dS) that both
# sides round: from fp32 values that differ in their last bits the two
# roundings can differ by one ulp of a term, and slack is 2^-7 times the
# root sum of squares of the sum's terms; zero where nothing is rounded.
TOL = {"bfloat16": (2.0 ** -7, 1e-3), "float32": (1e-4, 1e-4)}
# The lse route's fp32 dO reaches the tensor cores as two bf16 planes.  A
# kernel that dropped the lo plane errs by about one rounding of its bf16
# output, which TOL may pass, so each gradient's relative gap to the
# fp32-dO plain version must also be at most SPLIT_GAP times the gap of the
# plain version with dO rounded to bf16.  An H100 measured 0.06-0.11 of it
# (PERF.md); a kernel without the lo plane reads about 1.
SPLIT_GAP = 0.25
# The slice against a dense-attention twin made from the same seed, taking
# the same steps.  Step 0's loss is forward only; the gradients of step 0
# (|g_flash - g_dense| / |g_dense| for each parameter) go through the dQ and
# dK/dV kernels, and so do the weights of every later step.  The step-0
# loss is also held against the same weights with the attention through
# the plain forward, with and without its bf16 rounding of P.  The model
# keeps its residual stream in bf16, so two forwards that differ only in
# the last bits of the attention output round the stream differently and
# end about 1.4e-4 apart (PERF.md): LOSS_TOL is about twice that noise.
# GRAD_TOL and STEP_LOSS_TOL are about twice the gap measured on an H100
# (2.6e-2, 5.6e-3 with fp32 P) and below what planted faults read, some
# only just (PERF.md): the kernel checks above are the guard, this is the
# backstop.
LOSS_TOL = 3e-4
GRAD_TOL = 5e-2
STEP_LOSS_TOL = 1e-2
# The ResNet-50 phase against an fp32 twin from the same seed (TF32 off):
# |loss_bf16 - loss_fp32| at step 0, each parameter's step-0 gradient as
# |g - g_twin| / |g_twin| (the largest over the layers for each parameter
# name), and the stem batch norm's running mean and variance after step 0
# as |s - s_twin| / |s_twin|.  Each is about twice what an H100 measured
# (PERF.md).  Below the head the gradients of a freshly initialized
# ResNet-50 amplify rounding: fp32 against fp64 they differ by 2-3e-2, and
# the bf16 ones are uncorrelated with fp64's (gaps 1.2-2.3, cosines near 0),
# as the JAX package's rounding points make them.  So only the head's
# gradients are held tightly, the rest only to stay finite and in scale.
RESNET_LOSS_TOL = 1e-3
RESNET_GRAD_TOL = {"head_b": 3e-3, "head_w": 0.3}
RESNET_GRAD_TOL_BODY = 5.0
RESNET_STATS_TOL = {"mean": 3e-3, "var": 1e-6}
# The sequence-parallel phase: ring and Ulysses attention of SP_RANKS
# virtual ranks (``ring_attention.loopback_attention``, which runs the
# gang's schedule in one process) at the flagship's width, against the
# flash kernels over the whole sequence with the same dO.  Each output and
# gradient as |got - want| / |want|, by impl, about twice the largest gap
# the first H100 run measured (ring 3.9e-3, Ulysses 5.4e-3; PERF.md): the
# ring rounds each hop's dQ, dK and dV to bf16 and adds them in bf16, and
# Ulysses rounds its scores to bf16, as the JAX package does.
SP_SHAPE = dict(B=8, S_local=1024, H=16, D=64)
SP_RANKS = 4
SP_TOL = {"ring": 8e-3, "ulysses": 1.1e-2}
# The flagship step in fp32 (compute_dtype float32, TF32 off) against a
# dense-attention fp32 twin from the same seed: |loss - loss_twin| at step
# 0 and each parameter's step-0 gradient as |g - g_twin| / |g_twin| (the
# largest over the layers for each parameter name), about twice what an
# H100 measured (9.5e-7, one fp32 ulp of the loss, and 2.4e-5; PERF.md).
F32_LOSS_TOL = 2e-6
F32_GRAD_TOL = 5e-5
# The pipelined flagship: loopback_pipeline's P stages of L/P layers each,
# M microbatches of B/M rows.  Its step-0 loss is held against the
# unpipelined flagship step's with LOSS_TOL, its later losses with
# STEP_LOSS_TOL, and its step-0 gradients with PP_GRAD_TOL: the same
# weights and batches, the same bf16 residual stream, the same kernels
# (at the microbatch's shape), so the gradients differ only by the order
# of the microbatches' bf16 sums.  PP_GRAD_TOL is its own bound, about
# twice the largest gap an H100 read (2.35e-3, in every block matrix, in
# each run that printed it; PERF.md): GRAD_TOL, 20 times that reading, is
# the flash-against-dense bound.
PP_STAGES, PP_MICRO = 4, 4
PP_GRAD_TOL = 5e-3
# Adasum over four virtual ranks' step-0 flagship gradients (fp32, 168 M
# elements each) against the float64 oracle, as |got - want| / |want|.
# Each round sums three fp32 dot products over the whole vector: with
# fp32 partial sums the relative error of each is of order 1e-7 to 1e-6,
# and so is that of each coefficient; two rounds give a few 1e-6.  1e-5
# leaves room above that and is far below the 0.1-1 a wrong coefficient or
# pairing gives (the combination of two gradients at cosine c moves by
# about c/2 of a gradient).
ADASUM_RANKS = 4
ADASUM_TOL = 1e-5


def _sh(cmd):
    return subprocess.run(cmd, capture_output=True, text=True,
                          check=True).stdout.strip()


def _peaks(name):
    for key, val in PEAKS.items():
        if key in name:
            return key, val
    raise RuntimeError(f"no published peaks for {name!r}; add its data "
                       "sheet's rates to PEAKS")


def _fail_if(failures, what):
    if failures:
        raise AssertionError(f"{what}: " + "; ".join(failures))


# The lanes' work in this process (``hvd.init()`` here, and the flagship
# trained on all the rows as a gang's reference) takes this lock: one
# reference at a time, as before the lanes.
_INPROC = threading.Lock()


class _LineRouter:
    """``sys.stdout`` while the lanes run: each thread's text goes out
    whole lines at a time, so that two lanes' lines never mix."""

    def __init__(self, real):
        self.real = real
        self.lock = threading.Lock()
        self.local = threading.local()

    def write(self, text):
        head, sep, tail = (getattr(self.local, "part", "")
                           + text).rpartition("\n")
        self.local.part = tail
        if sep:
            with self.lock:
                self.real.write(head + sep)
                self.real.flush()
        return len(text)

    def flush(self):
        pass  # a line goes out when it is whole

    def __getattr__(self, name):
        return getattr(self.real, name)


def _run_lanes(lanes):
    """Run the lanes ({name: function of no arguments, which runs its
    phases in order}) at once, each on a thread of its own, and return
    {name: its result}.  Every lane runs to its end; then the first
    failure, in the lanes' order, is raised."""
    results, errors, walls = {}, {}, {}

    def run(name, fn):
        t0 = time.perf_counter()
        try:
            results[name] = fn()
        except BaseException as e:  # raised below, once every lane ended
            errors[name] = e
            print(f"lanes: the {name} lane failed: {e!r}")
        finally:
            walls[name] = time.perf_counter() - t0

    real, t0 = sys.stdout, time.perf_counter()
    sys.stdout = _LineRouter(real)
    try:
        threads = [threading.Thread(target=run, args=lane,
                                    name=f"lane-{lane[0]}")
                   for lane in lanes.items()]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        sys.stdout = real
    print("lanes: " + ", ".join(f"{n} {walls[n]:.1f} s" for n in lanes)
          + f"; {time.perf_counter() - t0:.1f} s of wall time at once")
    for name in lanes:
        if name in errors:
            raise errors[name]
    return results


def _time_ms(fn, reps=20, batches=5, warmup=3):
    """Median over ``batches`` of the mean time of ``reps`` back-to-back
    calls of ``fn``, each batch between two CUDA events, after ``warmup``
    calls: a call's time on the card, or its host time where the host
    cannot keep the card busy."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(batches):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def _dev_us(e):
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


def _kernel_rows(prof):
    """The profile's device kernels by name, largest first.  A user range
    ("Optimizer.step#AdamW.step") also carries the device time of the
    kernels inside it, so ranges are left out."""
    from torch.autograd import DeviceType

    return sorted((e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and _dev_us(e) > 0
                   and not getattr(e, "is_user_annotation", False)
                   and not re.fullmatch(r"[\w.]+#[\w.]+", e.key)),
                  key=_dev_us, reverse=True)


def _device_ms(fn, reps=20, warmup=3, tries=3):
    """Device time of one call of ``fn``: the summed device time of the
    kernels that ``reps`` calls launch, under ``torch.profiler``, over
    ``reps``.  Unlike an event-timed loop it leaves out the gaps where the
    card waits for the host.  A profile that shows no device time at all
    (the profiler has dropped a window's kernels on the card) is taken
    again, up to ``tries`` times; then None: not measured."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(_dev_us(e) for e in _kernel_rows(prof))
        if us > 0:
            return us / reps / 1e3
    return None


def _device_ms_bounded(fn, bound_ms, tries=3):
    """``_device_ms``, taken again while it reads below ``bound_ms``, the
    least time the card can take for the work: a reading below it means
    the profiler dropped some of the window's kernel records.  None when
    every try did (or saw nothing): not measured by the profiler."""
    for _ in range(tries):
        ms = _device_ms(fn)
        if ms is not None and ms >= bound_ms:
            return ms
    return None


def _bound(kernel, B, S, H, D, dtype, causal, has_dlse, peaks,
           lse_route=False, cuda_cores=False):
    """Least time for the kernel's work: max(FLOPs / peak, bytes / rate),
    counting each input read once and each output written once, and only
    the query-key pairs the causal mask leaves.  Each product of two
    [pairs x D] operands is 2·D·pairs FLOPs at the rate of its operands'
    type: bf16 at the bf16 tensor-core rate; fp32 at the tf32 tensor-core
    rate, the least any tensor-core scheme of fp32-grade precision needs:
    the products of fp32 q/k/v, and on the lse route (``lse_route``: fp32
    output, fp32 dO) the products with dO (dO·Vᵀ, and Pᵀ·dO for dK/dV).
    ``cuda_cores``: fp32 q/k/v's products at the fp32 rate outside the
    tensor cores instead (the bound before the fp32 kernels used them).
    The split passes only move bytes, each fp32 input in and its bf16
    planes out: "split" dO's (two planes beside bf16 q/k/v, three beside
    fp32), "split_qkv" q, k and v's (three planes each)."""
    import torch

    pairs = B * H * (S * (S + 1) // 2 if causal else S * S)
    e = torch.empty((), dtype=dtype).element_size()
    e_do = 4 if lse_route else e
    n = B * S * H * D
    stats = 4 * B * S * H
    planes = 2 if e == 2 else 3
    # (products on q/k/v's type, products with dO)
    products = {"fwd": (2, 0), "dq": (2, 1), "dkv": (2, 2), "split": (0, 0),
                "split_qkv": (0, 0)}[kernel]
    nbytes = {"fwd": 3 * n * e + n * e_do + stats,
              "dq": 4 * n * e + n * e_do + stats * (2 + has_dlse),
              "dkv": 5 * n * e + n * e_do + stats * (2 + has_dlse),
              "split": 4 * n + planes * 2 * n,
              "split_qkv": 3 * (4 * n + 3 * 2 * n)}[kernel]
    bf16, tf32, f32, bw = peaks
    rate_qkv = bf16 if e == 2 else f32 if cuda_cores else tf32
    rate_do = tf32 if lse_route and e == 2 else rate_qkv
    t_ops = 2 * D * pairs * (products[0] / rate_qkv + products[1] / rate_do)
    t_bytes = nbytes / bw
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def _check(name, got, want, failures, slack=0.0):
    """Each element within TOL of the plain version (see TOL).  Prints the
    worst element's share of its tolerance (at most 1 passes), the relative
    error norm, and the max error over max |want|; returns the max abs
    error and appends to ``failures`` on a mismatch."""
    rtol, atol = TOL[str(got.dtype).split(".")[1]]
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    allowed = (rtol * want.abs() + atol * float(want.pow(2).mean().sqrt())
               + slack)
    worst = float((diff / allowed).max())
    err = float(diff.max())
    ok = worst <= 1.0
    print(f"  {name}: max_abs_err {err:.3e}  worst/tol {worst:.3f}  "
          f"|err|/|want| {float(diff.norm() / want.norm()):.2e}  "
          f"err/max|want| {err / float(want.abs().max()):.2e}  "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"{name} disagrees with its plain version "
                        f"(worst element at {worst:.3f} of its tolerance)")
    return err


def check_kernels(fa, B, S, H, D, dtype, causal, with_dlse, peaks, dev,
                  timed=True, lse_route=False):
    """Each kernel against its plain version on the same inputs; with
    ``timed``, times each and returns {kernel: measurements}.
    ``lse_route``: the ring hop's variants, as ``flash_attention_lse``
    runs them: the forward writes fp32 output, and the backward takes an
    fp32 dO (and a dlse where ``with_dlse``).  fp32 q/k/v (either route)
    also run the split passes, each held to its plain version bit for
    bit."""
    import torch
    import torch.nn.functional as F

    dname = str(dtype).split(".")[1]
    fp32 = dtype == torch.float32
    print(f"kernels at B {B} S {S} H {H} D {D} {dname} "
          f"{'causal' if causal else 'non-causal'}"
          f"{' dlse' if with_dlse else ''}"
          f"{' fp32 output and dO' if lse_route else ''}:")
    gen = torch.Generator(device=dev).manual_seed(S * 131 + D + lse_route)
    q, k, v, do = (torch.randn(B, S, H, D, device=dev, generator=gen)
                   for _ in range(4))
    # The lse route's dO is fp32 at full precision: its bf16 lo plane is
    # not zero.
    q, k, v = (t.to(dtype) for t in (q, k, v))
    do = do if lse_route else do.to(dtype)
    scale = 1.0 / math.sqrt(D)
    po, plse = fa._flash_fwd_plain(q, k, v, scale, causal, lse_route)
    dlse = (torch.randn(B, S, H, device=dev, generator=gen)
            if with_dlse else None)
    delta = (do.float() * po.float()).sum(-1)
    args = (q, k, v, do, plse, delta, dlse, scale, causal)

    o, lse = fa.flash_fwd_cuda(q, k, v, scale, causal, lse_route)
    dq = fa.flash_dq_cuda(*args)
    dk, dv = fa.flash_dkv_cuda(*args)
    torch.cuda.synchronize()
    pdq = fa._flash_dq_plain(*args)
    pdk, pdv = fa._flash_dkv_plain(*args)
    slack = fa.rounding_slack(*args)
    bad = []
    err = {"fwd": max(_check("fwd o", o, po, bad, slack["o"]),
                      _check("fwd lse", lse, plse, bad)),
           "dq": _check("dq", dq, pdq, bad, slack["dq"]),
           "dkv": max(_check("dk", dk, pdk, bad, slack["dk"]),
                      _check("dv", dv, pdv, bad, slack["dv"]))}

    def split_check(name, got, want):  # bit for bit
        err[name] = float((got.float() - want.float()).abs().max())
        same = torch.equal(got, want)
        print(f"  {name}: its planes {'equal' if same else 'DIFFER from'} "
              "their plain versions")
        if not same:
            bad.append(f"the {name} pass differs from its plain version")

    planes = qkv_planes = None
    if fp32:
        qkv_planes = fa.split_qkv_cuda(q, k, v)
        split_check("split_qkv", qkv_planes, fa._split_qkv_plain(q, k, v))
    if lse_route or fp32:
        n = fa.do_planes_of(dtype)
        planes = fa.split_do_cuda(do, n)
        split_check("split", planes, torch.stack(fa._split_plain(do, n)))
    if lse_route:
        # What the split buys (SPLIT_GAP): each gradient's gap to the plain
        # version, against the gap to it of the plain version with dO
        # rounded to bf16 (a kernel that dropped the lower planes).
        args16 = (q, k, v, do.to(torch.bfloat16).float()) + args[4:]
        p16 = (fa._flash_dq_plain(*args16),) + fa._flash_dkv_plain(*args16)
        gaps = {name: (_rel_gap(got, want), _rel_gap(rounded, want))
                for name, got, want, rounded in zip(
                    ("dq", "dk", "dv"), (dq, dk, dv), (pdq, pdk, pdv), p16)}
        print("  split precision, |got - plain| / |plain| against the "
              "bf16-dO plain version's: " + ", ".join(
                  f"{name} {g:.2e} vs {g16:.2e}"
                  for name, (g, g16) in gaps.items())
              + f" (at most {SPLIT_GAP} of it)")
        bad += [f"{name}'s gap to the fp32-dO plain version is not below "
                f"{SPLIT_GAP} of a bf16 dO's" for name, (g, g16)
                in gaps.items() if g > SPLIT_GAP * g16]
    _fail_if(bad, f"kernels at S {S} D {D} {dname}")
    if fp32:
        print(f"  dq_wgmma_kernel<{fa.kernel_head_dim(D)}, true, true>: "
              f"{_registers('dq', D, True, True)}")
    if not timed:
        return {}
    # The flash kernels run on the tensor cores; the splits are elementwise.
    impls = {kname: "wgmma" if kname in ("fwd", "dq", "dkv")
             else "elementwise" for kname in err}
    # One split serves the timed kernels, as in the forward and backward.
    qkv = dict(qkv_planes=qkv_planes) if fp32 else {}

    qh, kh, vh, doh = (t.transpose(1, 2).contiguous() for t in (q, k, v, do))
    qg, kg, vg = (t.detach().requires_grad_() for t in (qh, kh, vh))
    sdpa_out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal)

    def sdpa_bwd():  # one call: dQ, dK and dV together
        torch.autograd.grad(sdpa_out, (qg, kg, vg), doh, retain_graph=True)

    timing = {
        "fwd": (lambda: fa.flash_fwd_cuda(q, k, v, scale, causal, lse_route,
                                          **qkv),
                lambda: fa._flash_fwd_plain(q, k, v, scale, causal,
                                            lse_route),
                lambda: F.scaled_dot_product_attention(qh, kh, vh,
                                                       is_causal=causal)),
        "dq": (lambda: fa.flash_dq_cuda(*args, do_planes=planes, **qkv),
               lambda: fa._flash_dq_plain(*args), sdpa_bwd),
        "dkv": (lambda: fa.flash_dkv_cuda(*args, do_planes=planes, **qkv),
                lambda: fa._flash_dkv_plain(*args), sdpa_bwd),
    }
    # No PyTorch call splits a tensor into planes.
    if planes is not None:
        timing["split"] = (lambda: fa.split_do_cuda(do, n),
                           lambda: fa._split_plain(do, n), None)
    if fp32:
        timing["split_qkv"] = (lambda: fa.split_qkv_cuda(q, k, v),
                               lambda: fa._split_qkv_plain(q, k, v), None)
    out = {}
    for kname, (kern, plain, lib) in timing.items():
        # The kernel, its plain version and the library call do the same
        # work, so one bound holds all three readings.
        bound_ms, bound_by = _bound(kname, B, S, H, D, dtype, causal,
                                    with_dlse, peaks, lse_route)
        ms = _device_ms_bounded(kern, bound_ms)
        plain_ms = _device_ms_bounded(plain, bound_ms)
        lib_ms = None if lib is None else _device_ms_bounded(lib, bound_ms)
        event_ms = _time_ms(kern)
        # Where the profiler gave no reading, the events' time stands in
        # (it counts the host's gaps as well).
        timed_by = "events" if ms is None else "device"
        ms = event_ms if ms is None else ms
        plain_ms = _time_ms(plain) if plain_ms is None else plain_ms
        if lib is not None and lib_ms is None:
            lib_ms = _time_ms(lib)
        lib_txt = ("" if lib is None else
                   f"  sdpa{'' if kname == 'fwd' else ' bwd'} {lib_ms:.4f} ms")
        old = {}
        if fp32 and lib is not None:  # the fp32 CUDA cores' bound beside it
            old = dict(old_bound_ms=_bound(kname, B, S, H, D, dtype, causal,
                                           with_dlse, peaks, lse_route,
                                           cuda_cores=True)[0])
            lib_txt += f"  old bound {old['old_bound_ms']:.4f} ms"
        print(f"  {kname} ({impls[kname]}): kernel {ms:.4f} ms by "
              f"{timed_by} (events {event_ms:.4f} ms)  plain "
              f"{plain_ms:.3f} ms{lib_txt}  bound {bound_ms:.4f} ms "
              f"({bound_by})")
        out[kname] = dict(impl=impls[kname], max_abs_err=err[kname], ms=ms,
                          timed_by=timed_by, event_ms=event_ms,
                          plain_ms=plain_ms,
                          bound_ms=bound_ms, bound_by=bound_by,
                          library_ms=lib_ms, **old)
    if fp32:
        fwd = out["fwd"]["ms"] + out["split_qkv"]["ms"]
        bwd = out["dq"]["ms"] + out["dkv"]["ms"] + out["split"]["ms"]
        print(f"  fp32 forward with the q/k/v split {fwd:.4f} ms against "
              f"SDPA's forward {out['fwd']['library_ms']:.4f} ms; dQ, dK/dV "
              f"and the dO split {bwd:.4f} ms against SDPA's whole backward "
              f"{out['dkv']['library_ms']:.4f} ms")
    return out


def check_sass(lib_path):
    """Fails unless every instantiation of the wgmma kernels in the built
    library holds HGMMA (tensor-core) instructions; returns {kernel name:
    instantiations checked}."""
    from horovod_tpu_torch.ops import _build

    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = _sh([cuobjdump, "-sass", lib_path])
    # {mangled function name: its SASS}
    funcs, name = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            name = line.split("Function : ", 1)[1].strip()
            funcs[name] = []
        elif name is not None:
            funcs[name].append(line)
    found, bad = {}, []
    for kname in WGMMA_KERNELS:
        for fname, body in funcs.items():
            if kname in fname:
                found[kname] = found.get(kname, 0) + 1
                n = sum("HGMMA" in ln for ln in body)
                if n == 0:
                    bad.append(f"{fname} holds no HGMMA")
    print(f"sass: {found} instantiations, each with HGMMA"
          if not bad else f"sass: {bad}")
    # Five head-dim widths, each with bf16 q/k/v's two output types and
    # fp32 q/k/v (forward), or bf16 q/k/v's two dO types and fp32 q/k/v
    # (dQ, dK/dV).
    if found != {"fwd_wgmma_kernel": 15, "dkv_wgmma_kernel": 15,
                 "dq_wgmma_kernel": 15}:
        bad.append(f"wgmma instantiations found {found}")
    _fail_if(bad, "sass")
    return found


def _grad_gaps(model, twin):
    """|g - g_twin| / |g_twin| for each parameter, the largest over the
    layers for each parameter name: {name: gap}."""
    gaps = {}
    for (name, p), (_, t) in zip(model.named_parameters(),
                                 twin.named_parameters()):
        gap = float((p.grad.float() - t.grad.float()).norm()
                    / t.grad.float().norm())
        key = name.split(".")[-1]
        gaps[key] = max(gaps.get(key, 0.0), gap)
    return gaps


def _plain_step0_losses(tfm, fa, cfg, tokens, targets, dev):
    """The flagship's step-0 loss from the seed's weights with attention
    through the plain forward on the card: {"plain": with the kernels'
    rounding points, "plain fp32 P": on the inputs in fp32}."""
    from unittest import mock

    import torch

    def plain(q, k, v, scale, causal, out_f32=False, qkv_planes=None):
        return fa._flash_fwd_plain(q, k, v, scale, causal, out_f32)

    def plain_f32(q, k, v, scale, causal, out_f32=False, qkv_planes=None):
        o, lse = fa._flash_fwd_plain(q.float(), k.float(), v.float(), scale,
                                     causal, True)
        return o.to(torch.float32 if out_f32 else q.dtype), lse

    model = tfm.init(0, cfg, device=dev)
    losses = {}
    for name, fwd in (("plain", plain), ("plain fp32 P", plain_f32)):
        with torch.no_grad(), mock.patch.object(fa, "flash_fwd_cuda", fwd):
            losses[name] = float(tfm.loss_fn(model, tokens, targets))
    del model
    return losses


def _profile_step(step_fn, state, tokens, targets, step_ms, what="profile"):
    """One training step under ``torch.profiler``: prints the device time of
    the kernels by name (largest first) and their sum, which on one stream
    is the device's busy time, against the unprofiled median ``step_ms``;
    returns (state, the kernels' profiler rows)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = step_fn(state, tokens, targets)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    rows = _kernel_rows(prof)
    busy_ms = sum(_dev_us(e) for e in rows) / 1e3
    launches = sum(e.count for e in rows)
    print(f"{what}: kernels {busy_ms:.2f} ms in {launches} "
          f"launches; the profiled step took {wall_ms:.2f} ms, the median "
          f"step {step_ms:.2f} ms: device idle "
          f"{100 * (1 - busy_ms / step_ms):.1f}% of it")
    flash = [e for e in rows[12:]
             if re.search(r"\b(fwd|dq|dkv)(_wgmma)?_kernel<", e.key)]
    for e in rows[:12] + flash:
        print(f"{what}:   {_dev_us(e) / 1e3:8.3f} ms  x{e.count:<4d} "
              f"{e.key[:90]}")
    return state, rows


def run_slice(hvd, tfm, fa, make_mesh, dev, card):
    """Five flagship training steps, each followed by the same step of a
    dense-attention twin made from the same seed, and the step-0 loss with
    the plain attention; then, without the twin, ten timed steps.  Returns
    (launch counts, median step ms, steps, what :func:`_profile_step`
    needs)."""
    import dataclasses

    import torch

    cfg = tfm.TransformerConfig(
        vocab_size=32768, d_model=1024, n_layers=8, n_heads=16, d_ff=4096,
        max_seq_len=1024, compute_dtype=torch.bfloat16, attn_impl="flash",
        remat=True)
    B, S, steps = 8, 1024, 5
    mesh = make_mesh()
    step_fn, init_fn = hvd.make_transformer_train_step(cfg, mesh=mesh)
    twin_step, twin_init = hvd.make_transformer_train_step(
        dataclasses.replace(cfg, attn_impl="dense"))
    # HVD_NONFINITE_POLICY arms a user's DistributedOptimizer and the hvd
    # ResNet step, never this step (the JAX package's GSPMD step has no
    # guard): built with it set, the step must issue no agreement, so its
    # step-0 loss stays the no-mesh model's bit for bit.
    os.environ["HVD_NONFINITE_POLICY"] = "skip"
    try:
        state = init_fn(0)
    finally:
        del os.environ["HVD_NONFINITE_POLICY"]
    twin = twin_init(0)
    gen = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), device=dev,
                           generator=gen)
    targets = torch.roll(tokens, -1, dims=1)
    with torch.no_grad():  # the step built without a mesh, as before
        no_mesh_loss = float(tfm.loss_fn(state.model, tokens, targets))
    torch.cuda.reset_peak_memory_stats()

    fa.reset_launch_counts()
    losses, twin_losses, times = [], [], []
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = step_fn(state, tokens, targets)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
        twin, twin_loss = twin_step(twin, tokens, targets)
        twin_losses.append(float(twin_loss))
        if i == 0:
            gaps = _grad_gaps(state.model, twin.model)
    counts = dict(fa.launches)
    step0 = dict(_plain_step0_losses(tfm, fa, cfg, tokens, targets, dev),
                 flash=losses[0], dense=twin_losses[0])

    bad = []
    print(f"slice: step built with mesh {mesh.shape} (and "
          f"HVD_NONFINITE_POLICY=skip set, guard "
          f"{state.optimizer.guard}): step-0 loss {losses[0]!r}, without a "
          f"mesh {no_mesh_loss!r}")
    if losses[0] != no_mesh_loss:
        bad.append("the step through make_mesh() moves the step-0 loss")
    if state.optimizer.guard is not None:
        bad.append("HVD_NONFINITE_POLICY armed the transformer step")
    print(f"slice: flash losses {losses}")
    print(f"slice: dense twin losses {twin_losses}")
    spread = max(step0.values()) - min(step0.values())
    print(f"slice: step-0 losses {step0}, spread {spread:.3e} "
          f"(tol {LOSS_TOL})")
    diffs = [abs(a - b) for a, b in zip(losses, twin_losses)]
    print(f"slice: |flash - dense| per step {[f'{d:.3e}' for d in diffs]} "
          f"(tol {LOSS_TOL} at step 0, {STEP_LOSS_TOL} after)")
    print("slice: step-0 gradient gap to the dense twin, largest over "
          "layers: " + ", ".join(f"{k} {v:.2e}" for k, v in gaps.items())
          + f" (tol {GRAD_TOL})")
    if not all(math.isfinite(x) for x in losses):
        bad.append(f"non-finite loss: {losses}")
    if spread > LOSS_TOL:
        bad.append("step-0 losses disagree")
    if max(diffs[1:]) > STEP_LOSS_TOL:
        bad.append("a later step's loss disagrees with dense")
    if max(gaps.values()) > GRAD_TOL:
        bad.append("step-0 gradients disagree with dense")
    want = {"fwd": 16 * steps, "dq": 8 * steps, "dkv": 8 * steps, "split": 0}
    print(f"slice: kernel launches over {steps} steps {counts} "
          f"(want {want})")
    if counts != want:
        bad.append(f"launch counts {counts} != {want}")
    _fail_if(bad, "slice")
    print(f"slice: step times with the twin between them, ms {times}; "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
          "with the twin")
    del twin
    state, times, _ = _timed_steps(step_fn, state, tokens, targets, 2 * steps)
    step_ms = statistics.median(times)
    print(f"slice: step times alone, ms {times}")
    print(f"slice: median step {step_ms:.2f} ms, "
          f"{B * S / step_ms * 1e3:.0f} tokens/s on {card}")
    return counts, step_ms, steps, (step_fn, state, tokens, targets, step_ms)


def _moe_routes(tfm, model, tokens, mesh):
    """One forward without remat or gradients at the model's weights: the
    routing of each MoE layer (``transformer.apply``'s ``stats``)."""
    import torch

    stats = []
    with torch.no_grad():
        tfm.apply(model, tokens, mesh=mesh, remat=False, stats=stats)
    return stats


def run_moe(hvd, tfm, fa, make_mesh, dev, card):
    """The flagship with the Switch MoE FFN (8 experts, capacity factor
    1.25) at full width: five steps through
    ``make_transformer_train_step(cfg, mesh=make_mesh())``, each followed
    by the same step of a dense-attention twin made from the same seed.  A
    bf16 difference in attention flips some tokens' experts, and a flip
    moves every later token's place in that expert's buffer, so which
    tokens drop: the tokens the twin routes elsewhere by itself are
    printed, and at step 0 the twin replays the flash model's routing
    (``transformer._route``), so that the step-0 loss and every gradient
    are held against the twin's with the flagship's tolerances; later
    steps run on their own routing; 16 forward, 8 dQ and 8 dK/dV launches
    a step;
    each layer's dropped share and aux loss; then ten timed steps.
    Returns (launch counts, median step ms, steps, what
    :func:`_profile_step` needs)."""
    import dataclasses
    from unittest import mock

    import torch

    cfg = tfm.TransformerConfig(
        vocab_size=32768, d_model=1024, n_layers=8, n_heads=16, d_ff=4096,
        max_seq_len=1024, compute_dtype=torch.bfloat16, attn_impl="flash",
        remat=True, n_experts=8, capacity_factor=1.25)
    B, S, steps = 8, 1024, 5
    mesh = make_mesh()
    step_fn, init_fn = hvd.make_transformer_train_step(cfg, mesh=mesh)
    twin_step, twin_init = hvd.make_transformer_train_step(
        dataclasses.replace(cfg, attn_impl="dense"))
    state, twin = init_fn(0), twin_init(0)
    n_params = sum(p.numel() for p in state.model.parameters())
    n_expert = sum(p.numel() for n, p in state.model.named_parameters()
                   if n.split(".")[-1] in ("w_in", "w_gate", "w_out"))
    gen = torch.Generator(device=dev).manual_seed(5)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), device=dev,
                           generator=gen)
    targets = torch.roll(tokens, -1, dims=1)
    bad = []
    routes = _moe_routes(tfm, state.model, tokens, mesh)
    twin_routes = _moe_routes(tfm, twin.model, tokens, None)
    flipped = [int((a["expert"] != b["expert"]).sum())
               for a, b in zip(routes, twin_routes)]
    torch.cuda.reset_peak_memory_stats()

    # Step 0's twin replays the flash model's routing, call by call (each
    # layer's forward, then its recompute in the backward): the twins then
    # keep and drop the same tokens and differ only in their attention.
    recorded, real_route = [], tfm._route

    def record(gates):
        expert, gate = real_route(gates)
        recorded.append(expert)
        return expert, gate

    def replay(gates):
        expert = recorded.pop(0)
        return expert, gates.gather(-1, expert[:, None])[:, 0]

    fa.reset_launch_counts()
    losses, twin_losses, times = [], [], []
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with mock.patch.object(tfm, "_route", record if i == 0
                               else real_route):
            state, loss = step_fn(state, tokens, targets)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
        with mock.patch.object(tfm, "_route", replay if i == 0
                               else real_route):
            twin, twin_loss = twin_step(twin, tokens, targets)
        twin_losses.append(float(twin_loss))
        if i == 0:
            gaps = _grad_gaps(state.model, twin.model)
            if recorded:
                bad.append(f"{len(recorded)} recorded routings not replayed")
    counts = dict(fa.launches)
    peak = torch.cuda.max_memory_allocated() / 2**30

    print(f"moe: {n_params / 1e9:.3f} G parameters, {n_expert / 1e9:.3f} G "
          f"of them in the experts; capacity "
          f"{max(1, int(cfg.capacity_factor * S * B / cfg.n_experts))} "
          "tokens an expert a layer")
    print("moe: at the seed's weights, per layer: dropped share "
          + ", ".join(f"{float(r['dropped']) / r['tokens']:.4f}"
                      for r in routes)
          + "; aux loss " + ", ".join(f"{float(r['aux']):.4f}"
                                      for r in routes))
    print(f"moe: tokens the dense-attention twin routes to another expert "
          f"by itself, per layer (of {B * S}): {flipped}; at step 0 it "
          "replays the flash model's routing")
    print(f"moe: flash losses {losses}")
    print(f"moe: dense twin losses {twin_losses} (from step 1 on its own "
          "routing: reported)")
    diff0 = abs(losses[0] - twin_losses[0])
    print(f"moe: step-0 |flash - dense| {diff0:.3e} (tol {LOSS_TOL})")
    print("moe: step-0 gradient gap to the dense twin, largest over layers: "
          + ", ".join(f"{k} {v:.2e}" for k, v in gaps.items())
          + f" (tol {GRAD_TOL})")
    if not all(math.isfinite(x) for x in losses):
        bad.append(f"non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        bad.append(f"loss did not fall over {steps} steps: {losses}")
    if diff0 > LOSS_TOL:
        bad.append("step-0 loss disagrees with the dense twin")
    if max(gaps.values()) > GRAD_TOL:
        bad.append("step-0 gradients disagree with the dense twin")
    want = {"fwd": 16 * steps, "dq": 8 * steps, "dkv": 8 * steps, "split": 0}
    print(f"moe: kernel launches over {steps} steps {counts} (want {want})")
    if counts != want:
        bad.append(f"launch counts {counts} != {want}")
    _fail_if(bad, "moe")
    print(f"moe: step times with the twin between them, ms {times}; peak "
          f"memory {peak:.2f} GiB with the twin")
    del twin
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state, times, _ = _timed_steps(step_fn, state, tokens, targets, 2 * steps)
    step_ms = statistics.median(times)
    print(f"moe: step times alone, ms {times}")
    print(f"moe: median step {step_ms:.2f} ms, "
          f"{B * S / step_ms * 1e3:.0f} tokens/s on {card}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return counts, step_ms, steps, (step_fn, state, tokens, targets, step_ms)


def run_guard(hvd, dev):
    """The non-finite gradient guard on the card: a small model's
    ``DistributedOptimizer(AdamW)`` with a NaN planted in one gradient
    entry.  ``skip``: parameters and AdamW state bit for bit as before the
    step, one skip counted; ``zero``: the step equals the step taken with
    that entry zeroed; ``off`` issues one allreduce (the gradients' one
    dtype) and ``skip`` one more, the agreement."""
    import torch
    import torch.distributed as dist

    from horovod_tpu_torch.integrity import nonfinite as nf

    def model():
        torch.manual_seed(0)
        return torch.nn.Sequential(torch.nn.Linear(64, 128), torch.nn.GELU(),
                                   torch.nn.Linear(128, 8)).to(dev)

    x = torch.randn(32, 64, device=dev, generator=torch.Generator(
        device=dev).manual_seed(6))

    def step(net, opt, poison=None):
        opt.zero_grad()
        net(x).square().mean().backward()
        if poison is not None:
            net[0].weight.grad[3, 5] = poison
        opt.step()

    def snapshot(net, opt):
        return ([p.detach().clone() for p in net.parameters()],
                [t.clone() for st in opt.inner.state.values()
                 for t in st.values()])

    def same(a, b):
        return all(torch.equal(u, v) for u, v in zip(a[0] + a[1],
                                                     b[0] + b[1]))

    def adamw(net):
        return torch.optim.AdamW(net.parameters(), lr=1e-3)

    bad = []
    nf.reset_counters()
    net = model()
    opt = hvd.DistributedOptimizer(adamw(net), nonfinite_policy="skip")
    step(net, opt)
    before = snapshot(net, opt)
    step(net, opt, poison=float("nan"))
    skipped_same = same(before, snapshot(net, opt))
    print(f"guard: skip: NaN planted, parameters and AdamW state bit for bit "
          f"unchanged {skipped_same}; guard skipped {opt.guard.skipped}, "
          f"counters {nf.counters()}")
    if not (skipped_same and opt.guard.skipped == 1
            and nf.counters() == {"agreed": 1, "skipped": 1}):
        bad.append("skip did not leave the step untouched and counted once")
    step(net, opt)
    if same(before, snapshot(net, opt)):
        bad.append("skip: the next good step did not apply")

    net_z, net_ref = model(), model()
    opt_z = hvd.DistributedOptimizer(adamw(net_z), nonfinite_policy="zero")
    opt_ref = hvd.DistributedOptimizer(adamw(net_ref), nonfinite_policy="off")
    step(net_z, opt_z, poison=float("inf"))
    step(net_ref, opt_ref, poison=0.0)
    zero_same = same(snapshot(net_z, opt_z), snapshot(net_ref, opt_ref))
    print(f"guard: zero: the step with an Inf equals the step with that "
          f"entry zeroed, bit for bit: {zero_same}")
    if not zero_same:
        bad.append("zero differs from the step with the entry zeroed")

    calls = {}
    real = dist.all_reduce
    for policy in ("off", "skip"):
        n = [0]

        def spy(*a, n=n, **k):
            n[0] += 1
            return real(*a, **k)

        net = model()
        opt = hvd.DistributedOptimizer(adamw(net), nonfinite_policy=policy)
        dist.all_reduce = spy
        try:
            step(net, opt)
        finally:
            dist.all_reduce = real
        calls[policy] = n[0]
    print(f"guard: allreduces per step {calls} (off: the gradients' one; "
          "skip: one more, the agreement)")
    if calls != {"off": 1, "skip": 2}:
        bad.append(f"allreduces per step {calls}")
    _fail_if(bad, "guard")


def run_fp32_step(hvd, tfm, fa, dev):
    """One full-width flagship step in fp32 (``compute_dtype`` float32,
    flash attention) through ``make_transformer_train_step``, beside a
    dense-attention fp32 twin made from the same seed: the step-0 loss and
    every gradient against the twin's, and the step's launches of the fp32
    kernels.  Checked, not timed.  Returns the launches by variant."""
    import dataclasses

    import torch

    f32 = torch.float32
    cfg = tfm.TransformerConfig(
        vocab_size=32768, d_model=1024, n_layers=8, n_heads=16, d_ff=4096,
        max_seq_len=1024, compute_dtype=f32, attn_impl="flash", remat=True)
    B, S = 8, 1024
    step_fn, init_fn = hvd.make_transformer_train_step(cfg)
    twin_step, twin_init = hvd.make_transformer_train_step(
        dataclasses.replace(cfg, attn_impl="dense"))
    state, twin = init_fn(0), twin_init(0)
    gen = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), device=dev,
                           generator=gen)
    targets = torch.roll(tokens, -1, dims=1)
    fa.reset_launch_counts()
    state, loss = step_fn(state, tokens, targets)
    torch.cuda.synchronize()
    counts = dict(fa.variant_launches)
    twin, twin_loss = twin_step(twin, tokens, targets)
    gaps = _grad_gaps(state.model, twin.model)
    loss, twin_loss = float(loss), float(twin_loss)
    del state, twin

    bad = []
    print(f"fp32 step: step-0 loss {loss!r}, dense fp32 twin {twin_loss!r}, "
          f"gap {abs(loss - twin_loss):.3e} (tol {F32_LOSS_TOL})")
    print("fp32 step: step-0 gradient gap to the dense twin, largest over "
          "layers: " + ", ".join(f"{k} {v:.2e}" for k, v in gaps.items())
          + f" (tol {F32_GRAD_TOL})")
    want = {fa.variant("fwd", f32, causal=True): 16, "split qkv": 16,
            fa.variant("dq", f32, f32, True): 8,
            fa.variant("dkv", f32, f32, True): 8, "split": 8}
    print(f"fp32 step: launches {counts} (want {want})")
    if not math.isfinite(loss) or abs(loss - twin_loss) > F32_LOSS_TOL:
        bad.append("the step-0 loss disagrees with the dense twin")
    if max(gaps.values()) > F32_GRAD_TOL:
        bad.append("step-0 gradients disagree with the dense twin")
    if counts != want:
        bad.append(f"launches {counts} != {want}")
    _fail_if(bad, "fp32 step")
    return counts


def _flagship_cfg(tfm, **kw):
    """The flagship of ``bench.py:388-391`` (bf16, flash, remat)."""
    import torch

    return tfm.TransformerConfig(
        vocab_size=32768, d_model=1024, n_layers=8, n_heads=16, d_ff=4096,
        max_seq_len=1024, compute_dtype=torch.bfloat16, attn_impl="flash",
        remat=True, **kw)


def _token_batches(dev, n_batches, B=8, S=1024, vocab=32768, seed=7):
    """``n_batches`` flagship batches drawn through the port's input
    pipeline: an ``ArrayDataset`` of ``n_batches * B`` random sequences of
    ``S + 1`` tokens (the targets are the tokens shifted by one),
    ``ShardedSampler`` (one rank), ``batches`` and ``prefetch_to_device``
    onto the card.  The first batch must equal, bit for bit, the plain
    iteration's moved to the card.  Returns the batches as (tokens,
    targets) pairs on the card."""
    import numpy as np
    import torch

    from horovod_tpu_torch.data import (ArrayDataset, ShardedSampler,
                                        batches, prefetch_to_device)

    seqs = np.random.RandomState(seed).randint(
        0, vocab, (n_batches * B, S + 1)).astype(np.int64)
    ds = ArrayDataset(seqs[:, :-1], seqs[:, 1:])

    def loader():
        return batches(ds, ShardedSampler(len(ds), 0, 1, seed=seed), B)

    got = list(prefetch_to_device(loader(), device=dev))
    plain = next(loader())
    same = all(torch.equal(g, torch.from_numpy(a).to(dev))
               for g, a in zip(got[0], plain))
    print(f"data: {len(got)} batches of {B} x {S} tokens through "
          f"ShardedSampler, batches and prefetch_to_device (pinned memory, "
          f"a side stream); on {got[0][0].device}; the first equals the "
          f"plain iteration's bit for bit: {same}")
    if not same or len(got) != n_batches or got[0][0].device != dev:
        raise AssertionError("data: prefetch_to_device does not give the "
                             "plain iteration's batches on the card")
    return got


def run_pipeline(hvd, tfm, fa, dev, card):
    """The pipelined flagship: ``make_pipeline_train_step`` with
    ``n_stages=PP_STAGES`` (every stage's schedule in this process,
    ``loopback_pipeline``) and ``PP_MICRO`` microbatches, on batches from
    the input pipeline.  Three steps beside the unpipelined flagship step
    from the same weights on the same batches: step-0 loss and every
    step-0 gradient, later losses, falling finite losses, and the flash
    launches per step (bubble ticks skipped: each layer's forward runs
    once per stage and microbatch, and again in its recompute).  Then the
    checkpoint round trip (``save_verified`` after step 3, step 4,
    ``restore_verified`` into a state from another seed, step 4 again: the
    loss and every parameter bit for bit; a second checkpoint with one
    file corrupted: ``restore_verified`` falls back to the first), and
    five timed steps.  Returns (launch counts, median step ms, steps,
    what :func:`_profile_step` needs)."""
    import tempfile

    import torch

    from horovod_tpu_torch.parallel import pipeline as pl
    from horovod_tpu_torch.parallel import train
    from horovod_tpu_torch.utils import checkpoint as ckpt

    cfg = _flagship_cfg(tfm)
    steps = 3
    data = _token_batches(dev, steps + 2)
    step_fn, init_fn = pl.make_pipeline_train_step(
        cfg, n_stages=PP_STAGES, n_microbatches=PP_MICRO)
    state = init_fn(0)
    fa.reset_launch_counts()
    losses = []
    for i in range(steps):
        state, loss = step_fn(state, *data[i])
        losses.append(float(loss))
        if i == 0:
            grads = {k: p.grad.clone()
                     for k, p in state.model.named_parameters()}
    torch.cuda.synchronize()
    counts = dict(fa.launches)

    twin_step, twin_init = hvd.make_transformer_train_step(cfg)
    twin = twin_init(0)
    twin_losses, gaps = [], {}
    for i in range(steps):
        twin, loss = twin_step(twin, *data[i])
        twin_losses.append(float(loss))
        if i == 0:
            for k, p in twin.model.named_parameters():
                key = k.split(".")[-1]
                gaps[key] = max(gaps.get(key, 0.0), _rel_gap(grads[k],
                                                             p.grad))
    del twin, grads

    bad = []
    diffs = [abs(a - b) for a, b in zip(losses, twin_losses)]
    print(f"pp: loopback_pipeline, {PP_STAGES} stages x "
          f"{cfg.n_layers // PP_STAGES} layers, {PP_MICRO} microbatches of "
          f"{data[0][0].shape[0] // PP_MICRO} rows; losses {losses}")
    print(f"pp: unpipelined flagship losses {twin_losses}; |pp - plain| "
          f"{[f'{d:.3e}' for d in diffs]} (tol {LOSS_TOL} at step 0, "
          f"{STEP_LOSS_TOL} after)")
    print("pp: step-0 gradient gap to the unpipelined step, largest over "
          "layers: " + ", ".join(f"{k} {v:.2e}" for k, v in gaps.items())
          + f" (tol {PP_GRAD_TOL})")
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        bad.append(f"losses not finite and falling: {losses}")
    if diffs[0] > LOSS_TOL or max(diffs[1:]) > STEP_LOSS_TOL:
        bad.append("losses disagree with the unpipelined step")
    if max(gaps.values()) > PP_GRAD_TOL:
        bad.append("step-0 gradients disagree with the unpipelined step")
    per = PP_STAGES * PP_MICRO * (cfg.n_layers // PP_STAGES)
    want = {"fwd": 2 * per * steps, "dq": per * steps, "dkv": per * steps,
            "split": 0}
    print(f"pp: kernel launches over {steps} steps {counts} (want {want}: "
          f"bubble ticks skipped, each layer recomputed)")
    if counts != want:
        bad.append(f"launch counts {counts} != {want}")
    _fail_if(bad, "pp")

    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        ckpt.save_verified(root, train.state_tree(state), step=steps)
        save_s = time.perf_counter() - t0
        state, loss = step_fn(state, *data[steps])
        t0 = time.perf_counter()
        tree, at = ckpt.restore_verified(root)
        fresh = train.load_state_tree(init_fn(1), tree)
        restore_s = time.perf_counter() - t0
        del tree
        fresh, again = step_fn(fresh, *data[steps])
        same_params = all(torch.equal(a, b) for a, b in zip(
            state.model.state_dict().values(),
            fresh.model.state_dict().values()))
        del fresh
        second = ckpt.save_verified(root, train.state_tree(state),
                                    step=steps + 1)
        victim = os.path.join(second, os.listdir(second)[0])
        with open(victim, "r+b") as fh:  # one byte of the file, flipped
            fh.seek(os.path.getsize(victim) // 2)
            b = fh.read(1)
            fh.seek(-1, 1)
            fh.write(bytes([b[0] ^ 0xFF]))
        ok, reason = ckpt.verify_checkpoint(second)
        tree, fallback = ckpt.restore_verified(root)
        size = sum(os.path.getsize(os.path.join(d, f))
                   for d, _, fs in os.walk(root) for f in fs)
        del tree
    print(f"pp: checkpoint after step {at}: saved in {save_s:.1f} s, "
          f"restored into a state from another seed in {restore_s:.1f} s "
          f"({size / 2**30:.2f} GiB for two checkpoints); step {steps + 1} "
          f"resumed: loss {float(again)!r} against {float(loss)!r}, every "
          f"parameter equal: {same_params}")
    print(f"pp: second checkpoint with a byte flipped: verifies {ok} "
          f"({reason}); restore_verified fell back to step {fallback}")
    if at != steps or float(again) != float(loss) or not same_params:
        bad.append("the resumed step differs from the original")
    if ok or fallback != steps:
        bad.append("restore_verified did not fall back past the corrupted "
                   "checkpoint")
    _fail_if(bad, "pp checkpoint")

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    state, times, _ = _timed_steps(step_fn, state, *data[steps + 1], 5)
    step_ms = statistics.median(times)
    B, S = data[0][0].shape
    print(f"pp: step times alone, ms {times}")
    print(f"pp: median step {step_ms:.2f} ms, "
          f"{B * S / step_ms * 1e3:.0f} tokens/s on {card}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, of which "
          f"{base / 2**30:.2f} GiB allocated before the steps (this "
          "state, and the earlier phases' kept for their profiles)")
    # Where the memory goes: the same model's loss through the pipeline and
    # unpipelined, each forward and backward from the same state.
    for name, loss_fn in (
            ("pipelined", lambda: pl.pipeline_loss_fn(
                state.model, *data[steps + 1], n_stages=PP_STAGES,
                n_microbatches=PP_MICRO)),
            ("unpipelined", lambda: tfm.loss_fn(state.model,
                                                *data[steps + 1]))):
        state.optimizer.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        loss = loss_fn()
        torch.cuda.synchronize()
        fwd = torch.cuda.max_memory_allocated()
        held = torch.cuda.memory_allocated()
        loss.backward()
        torch.cuda.synchronize()
        bwd = torch.cuda.max_memory_allocated()
        print(f"pp: memory of the {name} loss on one state: "
              f"{base / 2**30:.2f} GiB before, peak {fwd / 2**30:.2f} in "
              f"the forward, {held / 2**30:.2f} held for the backward, "
              f"peak {bwd / 2**30:.2f} in the backward")
        del loss
    state.optimizer.zero_grad(set_to_none=True)
    return counts, step_ms, steps, (step_fn, state, *data[steps + 1],
                                    step_ms)


def run_zero1(hvd, tfm, make_mesh, dev):
    """``make_transformer_train_step(cfg, mesh=make_mesh(), zero1=True)``
    at one rank: the JAX package's "no dp axis > 1" warning, and its first
    two flagship steps bit for bit those of ``zero1=False``."""
    import logging

    import torch

    class Records(logging.Handler):
        def __init__(self):
            super().__init__()
            self.messages = []

        def emit(self, record):
            self.messages.append(record.getMessage())

    cfg = _flagship_cfg(tfm)
    gen = torch.Generator(device=dev).manual_seed(8)
    tokens = torch.randint(0, cfg.vocab_size, (8, 1024), device=dev,
                           generator=gen)
    targets = torch.roll(tokens, -1, dims=1)
    records = Records()
    logger = logging.getLogger("horovod_tpu_torch")
    logger.addHandler(records)
    try:
        zero_step, zero_init = hvd.make_transformer_train_step(
            cfg, mesh=make_mesh(), zero1=True)
    finally:
        logger.removeHandler(records)
    losses = {}
    for name, (step_fn, init_fn) in (
            ("zero1", (zero_step, zero_init)),
            ("plain", hvd.make_transformer_train_step(cfg,
                                                      mesh=make_mesh()))):
        state = init_fn(0)
        _, _, losses[name] = _timed_steps(step_fn, state, tokens, targets, 2)
        params = [p.detach().clone() for p in state.model.parameters()]
        del state
        if name == "zero1":
            zero_params = params
    same = all(torch.equal(a, b) for a, b in zip(zero_params, params))
    print(f"zero1: warnings {records.messages}; losses {losses['zero1']} "
          f"against zero1=False {losses['plain']}; parameters after two "
          f"steps equal: {same}")
    bad = []
    if records.messages != ["zero1=True but the mesh has no dp axis > 1; "
                            "optimizer state stays replicated"]:
        bad.append(f"warnings {records.messages}")
    if losses["zero1"] != losses["plain"] or not same:
        bad.append("the steps differ from zero1=False")
    _fail_if(bad, "zero1")


def run_adasum(tfm, dev, card):
    """Adasum over ADASUM_RANKS virtual ranks (``adasum_loopback``): each
    rank's gradient is the flagship's step-0 gradient (fp32, flattened) on
    its own seed's batch; the result against the port's float64 oracle
    (``adasum_reduce_numpy``) on the same gradients, within ADASUM_TOL;
    every virtual rank's result the same bit for bit."""
    import numpy as np
    import torch

    from horovod_tpu_torch.ops import adasum

    cfg = _flagship_cfg(tfm)
    model = tfm.init(0, cfg, device=dev)
    grads = []
    for r in range(ADASUM_RANKS):
        gen = torch.Generator(device=dev).manual_seed(100 + r)
        tokens = torch.randint(0, cfg.vocab_size, (8, 1024), device=dev,
                               generator=gen)
        model.zero_grad(set_to_none=True)
        tfm.loss_fn(model, tokens, torch.roll(tokens, -1, dims=1)).backward()
        grads.append(torch.cat([p.grad.reshape(-1)
                                for p in model.parameters()]))
    del model
    xs = torch.stack(grads)
    del grads
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = adasum.adasum_loopback(xs)
    torch.cuda.synchronize()
    card_ms = (time.perf_counter() - t0) * 1e3
    same = all(torch.equal(got[0], g) for g in got[1:])
    host = xs.cpu().numpy()
    cos = float(torch.nn.functional.cosine_similarity(xs[0], xs[1], dim=0))
    del xs
    t0 = time.perf_counter()
    want = adasum.adasum_reduce_numpy(list(host))
    oracle_s = time.perf_counter() - t0
    g = got[0].cpu().numpy().astype(np.float64)
    rel = float(np.linalg.norm(g - want) / np.linalg.norm(want))
    worst = float(np.abs(g - want).max() / np.abs(want).max())
    print(f"adasum: {ADASUM_RANKS} virtual ranks x {host.shape[1]} fp32 "
          f"elements (the flagship's step-0 gradients, four seeds' batches; "
          f"cosine of ranks 0 and 1 {cos:.4f}); adasum_loopback "
          f"{card_ms:.1f} ms on {card}, float64 oracle {oracle_s:.1f} s on "
          f"the host")
    print(f"adasum: |got - oracle| / |oracle| {rel:.3e} (tol {ADASUM_TOL}), "
          f"max |got - oracle| / max |oracle| {worst:.3e}; every virtual "
          f"rank's result the same: {same}")
    if not same or not rel <= ADASUM_TOL:
        raise AssertionError("adasum: the loopback disagrees with the "
                             "float64 oracle")


# The serving phase: the flagship (bf16, dense FFN, weights from seed 0)
# behind FrontDoor, Scheduler and DecodeEngine in this process.  SERVE_SLOTS
# decode slots over a cache of SERVE_CACHE positions; SERVE_CLIENTS client
# threads post at once, with prompts of 32-512 tokens and 64-256 new tokens
# drawn from SERVE_SEED.  The served tokens must equal generate()'s on each
# prompt alone, bit for bit (rows never mix in the decode step); a request
# decoded beside neighbours must give, at every step, the logits and token
# it gives alone in the engine; and prefill_request's logits are held to
# the last position of apply() with dense attention within TOL["bfloat16"].
SERVE_SLOTS, SERVE_CACHE, SERVE_CLIENTS, SERVE_SEED = 8, 1024, 16, 11


def _serve_drive(scheduler, engine, stop, steps):
    """One rank's serving loop, in the order of the JAX package's
    ``serving/loop.py`` (``_drive``, ``_apply_frame``, ``_emit``): at each
    token boundary the scheduler's admissions, a prefill of each (its first
    token emitted), one ``step()`` when a slot is live, that step's token
    for every live slot, and a slot retired when its request has its
    tokens.  Runs until ``stop`` is set and no work is left; appends each
    step's (host ms, live slots) to ``steps``."""
    import torch

    live = {}

    def emit(slot, token):
        scheduler.on_token(slot, token)
        live[slot] -= 1
        if live[slot] <= 0:
            engine.clear(slot)
            del live[slot]
            scheduler.complete(slot)

    while not (stop.is_set() and not scheduler.has_work()):
        admissions = scheduler.take_admissions()
        if not admissions and not live:
            time.sleep(0.001)
            continue
        for slot, req in admissions:
            live[slot] = req.max_new
            emit(slot, engine.prefill(slot, req.prompt))
        if live:
            n = len(live)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            toks = engine.step()  # the tokens reach the host: synchronized
            steps.append(((time.perf_counter() - t0) * 1e3, n))
            for slot in sorted(live):
                emit(slot, int(toks[slot]))


def _post(port, body, out, i):
    """One client: POST ``body`` to ``/generate``; ``out[i]`` = (status,
    the reply's JSON)."""
    import http.client

    c = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        c.request("POST", "/generate", json.dumps(body))
        r = c.getresponse()
        out[i] = (r.status, json.loads(r.read() or b"{}"))
    finally:
        c.close()


def _engine_alone(engine, prompt, n, neighbours=()):
    """Decode ``prompt`` in slot 0 of ``engine`` for ``n`` tokens, the other
    slots idle or holding ``neighbours`` (prompts for slots 1, 2, ...):
    slot 0's tokens and each step's logits."""
    for s in range(engine.max_batch):
        engine.clear(s)
    toks = [engine.prefill(0, prompt)]
    for s, p in enumerate(neighbours, start=1):
        engine.prefill(s, p)
    logits = []
    for _ in range(n - 1):
        toks.append(int(engine.step()[0]))
        logits.append(engine.logits[0].clone())
    for s in range(engine.max_batch):
        engine.clear(s)
    return toks, logits


def run_serve(tfm, dev, card):
    """The flagship served: ``DecodeEngine`` (SERVE_SLOTS slots, cache
    SERVE_CACHE), ``Scheduler`` and ``FrontDoor`` on 127.0.0.1, driven by
    :func:`_serve_drive` in one thread while SERVE_CLIENTS threads post
    ``/generate`` at once.  Checks every reply (200, its tokens), the
    tokens against ``generate`` alone on each prompt, slot independence bit
    for bit, and ``prefill_request`` against ``apply``; prints TTFT, the
    decode step at eight live slots, one profiled decode step, prefill
    times, the KV cache's bytes and the peak memory."""
    import threading

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from horovod_tpu_torch.serving import DecodeEngine, FrontDoor, Scheduler

    t_phase = time.perf_counter()
    cfg = _flagship_cfg(tfm)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    model = tfm.init(0, cfg, device=dev)
    engine = DecodeEngine(model, cfg, max_batch=SERVE_SLOTS,
                          cache_len=SERVE_CACHE, device=dev)
    kv_bytes = engine.ks.nbytes + engine.vs.nbytes
    cast_bytes = sum(t.nbytes for t in [engine.model.embed] + [
        t for blk in engine.model.layers for t in vars(blk).values()]
        if t.dtype == cfg.compute_dtype)
    print(f"serve: flagship (vocab {cfg.vocab_size}, d_model {cfg.d_model}, "
          f"{cfg.n_layers} layers, {cfg.n_heads} heads, d_ff {cfg.d_ff}, "
          f"bf16, seed 0); DecodeEngine {SERVE_SLOTS} slots x cache "
          f"{SERVE_CACHE}: KV cache {kv_bytes} bytes "
          f"({kv_bytes / 2**20:.0f} MiB), matrices cast once "
          f"{cast_bytes} bytes ({cast_bytes / 1e6:.0f} MB)")

    rs = np.random.RandomState(SERVE_SEED)
    reqs = []
    for _ in range(SERVE_CLIENTS):
        n = int(rs.randint(32, 513))
        new = int(rs.randint(64, 257))
        reqs.append((rs.randint(0, cfg.vocab_size, n).tolist(), new))
    assert all(len(p) + m <= SERVE_CACHE for p, m in reqs)

    # Prefill times (host clock, synchronized), at prompts of 128 and 512.
    prefill_ms = {}
    for n in (128, 512):
        prompt = reqs[0][0] * 16
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            engine.prefill(0, prompt[:n])
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        prefill_ms[n] = statistics.median(times[1:])
    # The decode step at eight live slots with no server running.
    for s, (p, _) in enumerate(reqs[:SERVE_SLOTS]):
        engine.prefill(s, p)
    quiet = []
    for _ in range(23):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.step()
        quiet.append((time.perf_counter() - t0) * 1e3)
    for s in range(SERVE_SLOTS):
        engine.clear(s)

    # The telemetry registry on: the front door's and the scheduler's
    # request counters, gauges and TTFT histogram.
    from horovod_tpu_torch.telemetry import registry as tmx

    tmx.configure(False)
    tmx.configure(True)
    sched = Scheduler(max_batch=SERVE_SLOTS, max_queue=64,
                      cache_len=SERVE_CACHE)
    door = FrontDoor(sched, host="127.0.0.1", port=0, timeout_s=600.0)
    port = door.start()
    stop, steps, err = threading.Event(), [], []

    def drive():
        try:
            _serve_drive(sched, engine, stop, steps)
        except BaseException as e:  # noqa: B036 -- reported below
            err.append(e)
            sched.fail_all(f"the serving loop failed: {e!r}")
            raise

    stepper = threading.Thread(target=drive, name="serve-loop")
    replies = [None] * SERVE_CLIENTS
    clients = [threading.Thread(target=_post, args=(
        port, {"prompt": p, "max_new_tokens": m}, replies, i))
        for i, (p, m) in enumerate(reqs)]
    t0 = time.perf_counter()
    stepper.start()
    for c in clients:
        c.start()
    for c in clients:
        c.join(timeout=600)
    serve_s = time.perf_counter() - t0
    stop.set()
    stepper.join(timeout=60)
    door.stop()
    if err:
        raise err[0]
    served = tmx.snapshot()["counters"]
    sstats = sched.stats()
    tmx.configure(False)
    n_ok = served.get('hvd_serve_requests_total{status="ok"}')
    if n_ok != SERVE_CLIENTS or "ttft_p99_ms" not in sstats:
        raise AssertionError(f"serve: hvd_serve_requests_total {served}, "
                             f"stats {sstats}, want {SERVE_CLIENTS} ok")
    bad = []
    for i, ((p, m), r) in enumerate(zip(reqs, replies)):
        if r is None or r[0] != 200 or len(r[1].get("tokens", ())) != m:
            bad.append(f"request {i}: reply {r and r[0]} "
                       f"{str(r and r[1])[:120]}")
    _fail_if(bad, "serve")

    # The tokens against generate() on each prompt alone.
    t_or = time.perf_counter()
    wants = []
    for i, (p, m) in enumerate(reqs):
        want = tfm.generate(model, [p], max_new_tokens=m,
                            cache_len=SERVE_CACHE)[0, len(p):].tolist()
        wants.append(want)
        got = replies[i][1]["tokens"]
        if got != want:
            j = next(k for k in range(m) if got[k] != want[k])
            _, logits = _engine_alone(engine, p, j + 1)
            top = (torch.topk(logits[j - 1], 2).values.tolist() if j
                   else None)
            bad.append(f"request {i}: tokens leave generate()'s at step "
                       f"{j} (top-2 logits there {top})")
    oracle_s = time.perf_counter() - t_or
    _fail_if(bad, "serve")

    # Slot independence: request 0 alone in the engine, then beside seven
    # neighbours; every step's logits and token bit for bit.
    p0, m0 = reqs[0]
    n0 = min(m0, 64)
    alone, la = _engine_alone(engine, p0, n0)
    beside, lb = _engine_alone(engine, p0, n0,
                               [p for p, _ in reqs[1:SERVE_SLOTS]])
    same_logits = all(torch.equal(a, b) for a, b in zip(la, lb))
    print(f"serve: slot independence over {n0} tokens: tokens equal "
          f"{alone == beside}, logits equal at every step {same_logits}")
    if alone != beside or not same_logits:
        bad.append("a request beside neighbours decodes other logits or "
                   "tokens than alone")

    # prefill_request against the last position of apply(), dense attention.
    dense = tfm.Transformer(dataclasses.replace(cfg, attn_impl="dense"))
    dense.load_state_dict(model.state_dict())
    dense.to(dev)
    with torch.inference_mode():
        got, _, _ = tfm.prefill_request(
            engine.model, torch.tensor(p0, device=dev), SERVE_CACHE)
        want = tfm.apply(dense, torch.tensor([p0], device=dev))[0][0, -1]
    del dense
    rtol, atol = TOL["bfloat16"]
    allowed = rtol * want.abs() + atol * float(want.pow(2).mean().sqrt())
    worst = float(((got - want).abs() / allowed).max())
    print(f"serve: prefill_request logits against apply()'s last position "
          f"(dense attention), prompt {len(p0)}: max abs err "
          f"{float((got - want).abs().max()):.3e}, worst/tol {worst:.3f}, "
          f"bit for bit {torch.equal(got, want)}")
    if not worst <= 1.0:
        bad.append("prefill_request's logits disagree with apply()'s")
    _fail_if(bad, "serve")

    # One decode step at eight live slots under the profiler.
    for s, (p, _) in enumerate(reqs[:SERVE_SLOTS]):
        engine.prefill(s, p)
    engine.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        engine.step()
        torch.cuda.synchronize()
    rows = _kernel_rows(prof)
    busy_ms = sum(_dev_us(e) for e in rows) / 1e3
    launches = sum(e.count for e in rows)
    peak = torch.cuda.max_memory_allocated() - held

    full = [t for t, n in steps if n == SERVE_SLOTS]
    if not full:
        raise AssertionError("serve: no decode step ran with every slot "
                             "live")
    step_ms = statistics.median(full)
    ttft = sorted(r[1]["ttft_ms"] for r in replies)
    tokens = sum(m for _, m in reqs)
    print(f"serve: {SERVE_CLIENTS} requests, {tokens} tokens in "
          f"{serve_s:.2f} s ({tokens / serve_s:.1f} tokens/s), "
          f"{len(steps)} decode steps; TTFT p50 "
          f"{np.percentile(ttft, 50):.2f} ms, p99 "
          f"{np.percentile(ttft, 99):.2f} ms (host clock); "
          f"Scheduler.stats() from the TTFT histogram (log2 buckets' upper "
          f"bounds): p50 {sstats['ttft_p50_ms']} ms, p99 "
          f"{sstats['ttft_p99_ms']} ms; hvd_serve_requests_total "
          f"{ {k: v for k, v in served.items() if 'serve' in k} }; {card}")
    print(f"serve: decode step at {SERVE_SLOTS} live slots: median "
          f"{step_ms:.3f} ms over {len(full)} steps "
          f"({SERVE_SLOTS / step_ms * 1e3:.1f} tokens/s); with no server "
          f"running {statistics.median(quiet[3:]):.3f} ms; profiled step: "
          f"kernels {busy_ms:.3f} ms in {launches} launches, device idle "
          f"{100 * (1 - busy_ms / step_ms):.1f}% of the median")
    for e in rows[:8]:
        print(f"serve:   {_dev_us(e) / 1e3:8.3f} ms  x{e.count:<4d} "
              f"{e.key[:90]}")
    print(f"serve: prefill {prefill_ms[128]:.3f} ms at 128 tokens, "
          f"{prefill_ms[512]:.3f} ms at 512; peak memory "
          f"{peak / 2**30:.2f} GiB above the {held / 2**30:.2f} GiB held "
          f"before; oracles {oracle_s:.1f} s; phase "
          f"{time.perf_counter() - t_phase:.1f} s")
    return step_ms, wants


# The serving gang (phase 11): SG_RANKS ranks of this script
# (``--serve-gang-rank``) started by the port's launcher, every rank a
# ``ServingLoop`` over the flagship (SERVE_SLOTS slots, cache SERVE_CACHE)
# on the one card with no process group (NCCL refuses two ranks on one
# card).  A: the serve phase's SERVE_CLIENTS requests posted at once, the
# even ones to rank 0's door and the odd ones to the followers', which
# forward.  B: SG_B_REQUESTS of the same prompts under ids, rank 0
# SIGKILLed once every slot is live on every rank, the clients re-POSTing
# to rank 1's door.  SG_START_S bounds the launch up to every door open;
# SG_TIMEOUT_S the whole gang, launch to exit.  The engine's knobs are the
# launcher's defaults; HVD_TRACE is on, and the step, confirm and failover
# times come from the ranks' trace files (each process its own directory).
SG_RANKS, SG_MIN_NP, SG_B_REQUESTS = 3, 2, 8
SG_START_S, SG_TIMEOUT_S = 180, 420
# The tp serving gang (phase 11b, ``run_serve_gang_tp``): SG_TP ranks on
# the one card, ``ServingLoop(mesh={"tp": SG_TP})`` over a gloo group that
# the loop forms (the ranks share a card, which NCCL refuses), the
# flagship cut into SG_TP shards of its heads, d_ff and vocabulary, the
# group and the engine under a collective deadline of SG_TP_DEADLINE_S
# (``--collective-timeout``).  A: the same SERVE_CLIENTS requests, half
# through rank 1's door; the loop stops, and both ranks decode each prompt
# alone in a DecodeEngine at tp SG_TP (the oracle), then time SG_TP_STEPS
# steps with every slot live, with and without the tp collectives timed.
# B: both ranks serve again, SG_B_REQUESTS requests, rank 1 SIGKILLed once
# every slot is live; rank 0 re-forms alone at tp 1, replays them and
# times its steps.  The flagship at SG_TP_LAYERS layers, its full width:
# the two ranks time-slice the card and each tp collective copies through
# the host, so that at eight layers the oracle alone took 225.5 s and the
# phase 298.5 s (NVIDIA H100 80GB HBM3, 700.00 W), past the smoke's time;
# every comparison the phase prints is at that depth.
SG_TP, SG_TP_STEPS, SG_TP_LAYERS, SG_TP_DEADLINE_S = 2, 20, 2, 20.0


def _sg_write(path, text):
    with open(path + ".tmp", "w") as fh:
        fh.write(text)
    os.replace(path + ".tmp", path)


def _sg_wait(path, launcher, deadline, what):
    """Wait for ``path`` while the launcher runs; its text."""
    while time.monotonic() < deadline:
        if os.path.exists(path):
            with open(path) as fh:
                return fh.read()
        if launcher.poll() is not None:
            raise AssertionError(f"serve gang: the launcher exited "
                                 f"({launcher.returncode}) before {what}")
        time.sleep(0.01)
    raise AssertionError(f"serve gang: no {what} within the time limit")


def _sg_all_live(port, launcher, deadline):
    """Wait until the leader's ``/stats`` shows every slot active and then
    a step that ended after that reading.  That step's confirm allreduce
    needs every rank to have applied the frame that admitted the last of
    them, so every rank's slot table is full."""
    import urllib.request

    seen = None
    while time.monotonic() < deadline:
        if launcher.poll() is not None:
            raise AssertionError(f"serve gang: the launcher exited "
                                 f"({launcher.returncode}) before every "
                                 f"slot was live")
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/stats",
                                    timeout=10) as r:
            st = json.loads(r.read())
        now = time.monotonic()
        if seen is None:
            if st["active"] == SERVE_SLOTS:
                seen = now
        elif st["last_step_age_s"] and \
                now - st["last_step_age_s"] > seen + 0.002:
            return
        time.sleep(0.005)
    raise AssertionError("serve gang: not every slot live within the time "
                         "limit")


def _sg_client(ports, body, out, i, deadline):
    """POST ``body`` to ``ports[0]``; after a refused, broken or non-200
    answer re-POST it to ``ports[-1]`` until a 200 or ``deadline``;
    ``out[i]`` = (status or None, the reply or the error)."""
    import http.client

    port = ports[0]
    while time.monotonic() < deadline:
        c = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
        try:
            c.request("POST", "/generate", json.dumps(body))
            r = c.getresponse()
            out[i] = (r.status, json.loads(r.read() or b"{}"))
            if r.status == 200:
                return
        except (OSError, http.client.HTTPException, ValueError) as e:
            out[i] = (None, repr(e))
        finally:
            c.close()
        port = ports[-1]
        time.sleep(0.1)


def _sg_spans(d):
    """The spans of the trace files under ``d`` (one process's), by phase,
    each list in order of start; a line that a SIGKILL cut is skipped."""
    import glob

    spans = {}
    for fn in sorted(glob.glob(os.path.join(d, "*.jsonl"))):
        with open(fn) as fh:
            for line in fh:
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if rec.get("k") == "span":
                    spans.setdefault(rec["ph"], []).append(rec)
    for v in spans.values():
        v.sort(key=lambda r: r["t0"])
    return spans


def _sg_gang(tfm, cfg, rank_device, tp, timeout):
    """Launch a serving gang and drive it (see SG_RANKS and SG_TP): the
    launch, A's clients, B's clients and the SIGKILL of its victim (rank 0
    of the tp 1 gang, rank 1 of the tp gang), the reports, logs and
    traces; ``rank_device`` is every rank's device (None: each rank's own
    card, ``cuda:<local_rank>``).  Returns what the checks read."""
    import signal
    import shutil
    import tempfile
    import threading
    import types

    import numpy as np

    cache = min(SERVE_CACHE, cfg.max_seq_len)
    rs = np.random.RandomState(SERVE_SEED)
    reqs = []
    for _ in range(SERVE_CLIENTS):
        # The serve phase's draws at the flagship's cache (a narrower
        # rehearsal config shrinks them to fit).
        n = int(rs.randint(32, min(513, cache // 2 + 1)))
        new = int(rs.randint(min(64, cache // 4), min(257, cache // 2 + 1)))
        reqs.append((rs.randint(0, cfg.vocab_size, n).tolist(), new))
    assert all(len(pr) + m <= cache for pr, m in reqs)
    tmp = tempfile.mkdtemp(prefix="hvd-serve-gang-")
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    fields["compute_dtype"] = str(cfg.compute_dtype).split(".")[1]
    with open(os.path.join(tmp, "config.json"), "w") as fh:
        json.dump({"cfg": fields, "device": rank_device, "cache": cache,
                   "tp": tp, "reqs": reqs}, fh)
    n_ranks = SG_RANKS if tp == 1 else tp
    what = "serve gang" if tp == 1 else f"serve gang tp {tp}"
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("HVD_", "MASTER_", "HOROVOD_"))}
    # The serve channel is the Python engine's (the launcher's elastic
    # mode sets it too).
    env.update(HVD_TRACE="1", HVD_TPU_CORE="py",
               HVD_BLACKBOX_DIR=os.path.join(tmp, "blackbox"))
    here = os.path.dirname(os.path.abspath(__file__))
    env["PYTHONPATH"] = here + os.pathsep + env.get("PYTHONPATH", "")
    cmd = [sys.executable, "-m", "horovod_tpu_torch.runner.run",
           "-np", str(n_ranks), "--min-np",
           str(SG_MIN_NP if tp == 1 else 1)] + (
        ["--kv-standbys", "1"] if tp == 1 else
        ["--collective-timeout", str(SG_TP_DEADLINE_S)]) + [
        "--serve-max-batch", str(SERVE_SLOTS),
        "--no-shm", "--", sys.executable, os.path.abspath(__file__),
        "--serve-gang-rank", tmp]
    print(f"{what}: {' '.join(cmd[1:])}")
    p = os.path.join
    launcher, log_out, log_err, oracle = None, None, None, None
    a_out, b_out = [None] * len(reqs), [None] * SG_B_REQUESTS
    t0, t_kill_ns = time.monotonic(), 0
    try:
        log_out = open(p(tmp, "launcher.out"), "w")
        log_err = open(p(tmp, "launcher.err"), "w")
        launcher = subprocess.Popen(cmd, env=env, cwd=tmp, stdout=log_out,
                                    stderr=log_err)
        deadline = t0 + timeout
        start_by = min(deadline, t0 + SG_START_S)
        # Rank 0 writes its port once its address is in the KV store.
        ports = [int(_sg_wait(p(tmp, f"port{r}"), launcher, start_by,
                              f"rank {r}'s door")) for r in range(n_ranks)]
        t_up = time.monotonic() - t0

        # A: every request at once, half through the followers' doors.
        clients = [threading.Thread(target=_post, args=(
            ports[0] if i % 2 == 0 else ports[1 + (i // 2) % (n_ranks - 1)],
            {"prompt": pr, "max_new_tokens": m}, a_out, i), daemon=True)
            for i, (pr, m) in enumerate(reqs)]
        ta = time.monotonic()
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=max(1.0, deadline - time.monotonic()))
        a_s = time.monotonic() - ta
        t_dump_ns = time.monotonic_ns()
        _sg_write(p(tmp, "dumpA"), "1")
        for r in range(n_ranks):
            _sg_wait(p(tmp, f"A{r}.json"), launcher, deadline,
                     f"rank {r}'s report of A")
        if tp > 1:
            # The loop stops; the ranks run the oracle, then serve again.
            _sg_write(p(tmp, "stopA"), "1")
            oracle = json.loads(_sg_wait(p(tmp, "oracle.json"), launcher,
                                         deadline, "the ranks' oracle"))
            ports = [int(_sg_wait(p(tmp, f"portB{r}"), launcher, deadline,
                                  f"rank {r}'s second door"))
                     for r in range(n_ranks)]
        # B: every slot live on every rank, then the victim killed.
        victim = 0 if tp == 1 else 1
        b_reqs = [(f"B{i}", reqs[i][0], reqs[i][1])
                  for i in range(len(b_out))]
        clients = [threading.Thread(target=_sg_client, args=(
            [ports[0], ports[1]] if tp == 1 else [ports[0]],
            {"id": rid, "prompt": pr, "max_new_tokens": m}, b_out, i,
            deadline), daemon=True)
            for i, (rid, pr, m) in enumerate(b_reqs)]
        for c in clients:
            c.start()
        _sg_all_live(ports[0], launcher, deadline)
        pid_v = int(_sg_wait(p(tmp, f"pid{victim}"), launcher, deadline,
                             f"pid{victim}"))
        t_kill_ns = time.monotonic_ns()
        os.kill(pid_v, signal.SIGKILL)
        for c in clients:
            c.join(timeout=max(1.0, deadline - time.monotonic()))
        _sg_write(p(tmp, "stop"), "1")
        try:
            launcher.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            pass
        wall = time.monotonic() - t0
    finally:
        for r in range(n_ranks):
            try:
                with open(p(tmp, f"pid{r}")) as fh:
                    os.kill(int(fh.read()), signal.SIGKILL)
            except (OSError, ValueError):
                pass
        if launcher is not None and launcher.poll() is None:
            launcher.kill()
            launcher.wait()
        for fh in (log_out, log_err):
            if fh is not None:
                fh.close()
    survivors = (1, 2) if tp == 1 else (0,)
    reports = {}
    for name in [f"A{r}" for r in range(n_ranks)] + [
            f"final{r}" for r in survivors] + ["reform0"]:
        if os.path.exists(p(tmp, f"{name}.json")):
            with open(p(tmp, f"{name}.json")) as fh:
                reports[name] = json.load(fh)
    with open(p(tmp, "launcher.out")) as fh:
        out = fh.read()
    with open(p(tmp, "launcher.err")) as fh:
        err = fh.read()
    timeline = ""
    if os.path.exists(p(tmp, "timeline1.json")):
        with open(p(tmp, "timeline1.json")) as fh:
            timeline = fh.read()
    spans0, spans1 = _sg_spans(p(tmp, "trace0")), _sg_spans(p(tmp, "trace1"))
    shutil.rmtree(tmp, ignore_errors=True)
    for line in (out + err).splitlines():
        print(f"{what}: {line}")

    bad = []
    if launcher.returncode != 0:
        bad.append(f"the launcher exited {launcher.returncode}")
    for r in survivors:
        if f"[{r}]<stdout>: DONE" not in out:
            bad.append(f"survivor rank {r} did not finish")
    for i, r in enumerate(a_out):
        if r is None or r[0] != 200 or r[1].get("attempts") != 1 or \
                len(r[1].get("tokens", ())) != reqs[i][1]:
            bad.append(f"A request {i}: reply {str(r)[:160]}")
    for i, r in enumerate(b_out):
        if r is None or r[0] != 200 or not r[1].get("attempts", 0) > 1:
            bad.append(f"B request {i}: reply {str(r)[:160]}")
    # The leader's steps of A.
    lead = [s for s in spans0.get("serve.apply", ()) if s["t0"] < t_dump_ns]
    conf = [s for s in spans0.get("serve.confirm", ())
            if s["t0"] < t_dump_ns]
    if not (lead and conf):
        bad.append(f"the traces lack spans: {len(lead)} serve.apply and "
                   f"{len(conf)} serve.confirm of the leader in A")
    _fail_if(bad, what)
    return types.SimpleNamespace(
        what=what, reqs=reqs, cache=cache, n_ranks=n_ranks,
        survivors=survivors, a_out=a_out, b_out=b_out, reports=reports,
        timeline=timeline, spans1=spans1, lead=lead, conf=conf,
        oracle=oracle, t_up=t_up, a_s=a_s, wall=wall, t_kill_ns=t_kill_ns)


def _sg_ms(t0_ns, t1_ns):
    return (t1_ns - t0_ns) / 1e6


def _sg_print_a(g, card):
    """A's launch, TTFT and lockstep lines."""
    import numpy as np

    ttft = sorted(r[1]["ttft_ms"] for r in g.a_out)
    tokens = sum(m for _, m in g.reqs)
    lat = [_sg_ms(s["t0"], s["t1"]) for s in g.lead]
    conf_ms = [_sg_ms(s["t0"], s["t1"]) for s in g.conf]
    print(f"{g.what}: {g.n_ranks} ranks launched, every door open and the "
          f"leader published in {g.t_up:.2f} s; A: {len(g.reqs)} requests, "
          f"{tokens} tokens in {g.a_s:.2f} s ({tokens / g.a_s:.1f} "
          f"tokens/s), TTFT p50 {np.percentile(ttft, 50):.2f} ms, p99 "
          f"{np.percentile(ttft, 99):.2f} ms (host clock); {card}")
    print(f"{g.what}: lockstep step (the leader's serve.apply spans, the "
          f"window of hvd_serve_token_latency_seconds, {len(lat)} steps, "
          f"prefills included): median {statistics.median(lat):.3f} ms, p99 "
          f"{np.percentile(lat, 99):.3f} ms; the confirm allreduce (the "
          f"leader's serve.confirm spans, {len(conf_ms)} steps): median "
          f"{statistics.median(conf_ms):.3f} ms, p99 "
          f"{np.percentile(conf_ms, 99):.3f} ms a step; {card}")


def _sg_print_end(g, card, oracle_s, t_phase):
    peaks = {r: g.reports[f"A{r}"]["peak_bytes"] for r in range(g.n_ranks)}
    peaks.update({f"{r} (end)": g.reports[f"final{r}"]["peak_bytes"]
                  for r in g.survivors})
    print(f"{g.what}: peak memory per rank "
          + ", ".join(f"rank {r} " + (f"{v / 2**30:.2f} GiB" if v is not None
                                      else "not measured (CPU)")
                      for r, v in peaks.items())
          + f"; oracles {oracle_s:.1f} s; gang {g.wall:.1f} s; phase "
          f"{time.perf_counter() - t_phase:.1f} s; {card}")


def run_serve_gang(tfm, dev, card, step_alone_ms, alone,
                   timeout=SG_TIMEOUT_S):
    """The serving gang (see SG_RANKS): ``python -m
    horovod_tpu_torch.runner.run -np 3 --min-np 2 --kv-standbys 1
    --serve-max-batch 8`` over ranks of this script on ``dev``.  Checks:
    every reply of A is 200 with ``attempts == 1``; every request of B
    completes at rank 1's door with ``attempts > 1``; the tokens of both
    are, bit for bit, ``alone`` (the serve phase's ``generate`` oracle,
    which its ``DecodeEngine`` matched bit for bit); rank 1's timeline has
    ``LEADER_FAILOVER`` naming rank 0; the survivors print DONE and the
    launcher exits 0.  Prints TTFT, the lockstep step against the
    one-process decode step (``step_alone_ms``), the confirm allreduce,
    the failover by part and each rank's peak memory."""
    t_phase = time.perf_counter()
    g = _sg_gang(tfm, _flagship_cfg(tfm), str(dev), 1, timeout)
    bad = []
    recs = [json.loads(ln.rstrip().rstrip(","))
            for ln in g.timeline.splitlines() if "LEADER_FAILOVER" in ln]
    failover = [rec for rec in recs
                if 0 in ((rec.get("args") or {}).get("failed") or [])]
    if not failover:
        bad.append("rank 1's timeline has no LEADER_FAILOVER naming rank 0")
    # Rank 1's records of the failover.
    reform = [s for s in g.spans1.get("elastic.reform", ())
              if s["t0"] > g.t_kill_ns][:1]
    built = [s for s in g.spans1.get("serve.engine", ())
             if reform and s["t0"] >= reform[0]["t1"]][:1]
    after = [s for s in g.spans1.get("serve.apply", ())
             if built and s["t0"] >= built[0]["t1"]][:1]
    if not (reform and built and after):
        bad.append(f"the traces lack spans after the kill: rank 1's "
                   f"elastic.reform {len(reform)}, serve.engine "
                   f"{len(built)} and serve.apply {len(after)}")
    for i, r in enumerate(g.a_out):
        if r[1]["tokens"] != alone[i]:
            bad.append(f"A request {i}: tokens differ from the one-process "
                       f"decode's alone")
    for i, r in enumerate(g.b_out):
        if r[1]["tokens"] != alone[i]:
            bad.append(f"B request {i}: tokens differ from the one-process "
                       f"decode's alone")
    _fail_if(bad, g.what)
    _sg_print_a(g, card)
    print(f"{g.what}: the one-process decode step at the same depth and "
          f"{SERVE_SLOTS} live slots {step_alone_ms:.3f} ms; {card}")
    ms = _sg_ms
    rf, bl, af = reform[0], built[0], after[0]
    print(f"{g.what}: failover, SIGKILL of rank 0 to the end of rank 1's "
          f"first step after {ms(g.t_kill_ns, af['t1']):.1f} ms: detection "
          f"(to elastic.reform's start) {ms(g.t_kill_ns, rf['t0']):.1f} ms, "
          f"re-form (elastic.reform: teardown, the new world, re-init) "
          f"{ms(rf['t0'], rf['t1']):.1f} ms, to DecodeEngine rebuilt (state "
          f"sync, serve.engine) {ms(rf['t1'], bl['t1']):.1f} ms of which "
          f"the build {ms(bl['t0'], bl['t1']):.1f} ms, replay (publish, the "
          f"frame, {af.get('admitted')} prefills and a step, the first "
          f"serve.apply) {ms(bl['t1'], af['t1']):.1f} ms; rank 1's "
          f"LEADER_FAILOVER {failover[0].get('args')}; {card}")
    _sg_print_end(g, card, 0.0, t_phase)


def run_serve_gang_tp(tfm, dev, card, rank_device, cfg=None,
                      timeout=SG_TIMEOUT_S):
    """The tp serving gang (see SG_TP): ``-np SG_TP --min-np 1`` over
    ranks of this script, every one on ``rank_device`` (``cuda:0``: one
    card, where the loop forms a gloo group; None: each rank on its own
    card, an NCCL group, ``tools/torch_gang_4card.py``).  Checks, past
    the tp 1 gang's: A's tokens bit for bit the ranks' ``DecodeEngine``
    at tp SG_TP on each prompt alone; B's (rank 0 alone at tp 1 after rank
    1's SIGKILL, its first re-formed step at tp 1) bit for bit
    ``DecodeEngine``'s alone at tp 1, computed here after the gang; rank 0
    prints DONE.  Prints, at the same depth: the lockstep step at tp
    SG_TP against the loop's at tp 1 (B's survivor, a gang of one) and the
    decode step alone at tp 1 and at tp SG_TP; the tp collectives' share
    of a step; and rank 0's failover by part."""
    from horovod_tpu_torch.serving import DecodeEngine

    t_phase = time.perf_counter()
    cfg = cfg or dataclasses.replace(_flagship_cfg(tfm),
                                     n_layers=SG_TP_LAYERS)
    g = _sg_gang(tfm, cfg, rank_device, SG_TP, timeout)
    bad = []
    rf0 = g.reports.get("reform0")
    b_steps = g.reports.get("final0", {}).get("b_steps_ms") or []
    if rf0 is None or rf0["t_body"] < g.t_kill_ns or rf0["tp"] != 1 \
            or not b_steps:
        bad.append(f"rank 0's re-formed incarnation after the kill: {rf0}, "
                   f"{len(b_steps)} steps (its first step must run at tp "
                   f"1)")
    _fail_if(bad, g.what)
    # B's oracle: DecodeEngine alone at tp 1 on this process's card.
    t_or = time.perf_counter()
    model = tfm.init(0, cfg, device=dev)
    engine = DecodeEngine(model, cfg, max_batch=SERVE_SLOTS,
                          cache_len=g.cache, device=dev)
    alone = [_engine_alone(engine, pr, m)[0]
             for pr, m in g.reqs[:len(g.b_out)]]
    step_alone_ms = _sg_step_ms(engine, g.reqs, dev)
    del engine, model
    oracle_s = time.perf_counter() - t_or
    oracle = g.oracle
    for i, r in enumerate(g.a_out):
        if r[1]["tokens"] != oracle["tokens"][i]:
            bad.append(f"A request {i}: tokens differ from DecodeEngine's "
                       f"alone at tp {SG_TP}")
    for i, r in enumerate(g.b_out):
        if r[1]["tokens"] != alone[i]:
            bad.append(f"B request {i}: tokens differ from DecodeEngine's "
                       f"alone at tp 1")
    _fail_if(bad, g.what)
    _sg_print_a(g, card)
    print(f"{g.what}: at {cfg.n_layers} layers and {SERVE_SLOTS} live "
          f"slots: the loop's step at tp 1 (B's survivor, a gang of one, "
          f"{len(b_steps)} steps, replay prefills included) median "
          f"{statistics.median(b_steps):.3f} ms; DecodeEngine alone at tp 1 "
          f"{step_alone_ms:.3f} ms, at tp {SG_TP} on rank 0 "
          f"({SG_TP_STEPS} steps) {oracle['step_ms']:.3f} ms; with each tp "
          f"collective timed (the card synchronized around each) "
          f"{oracle['timed_step_ms']:.3f} ms, of which the "
          f"{oracle['collectives']} tp collectives {oracle['coll_ms']:.3f} "
          f"ms ({100 * oracle['coll_ms'] / oracle['timed_step_ms']:.1f}% "
          f"of the step); the oracle's {len(g.reqs)} prompts alone at tp "
          f"{SG_TP} {oracle['oracle_s']:.1f} s; {card}")
    ms = _sg_ms
    print(f"{g.what}: failover, SIGKILL of rank 1 to the end of rank 0's "
          f"first step at tp {rf0['tp']} after "
          f"{ms(g.t_kill_ns, rf0['t_step']):.1f} ms: to the re-formed "
          f"incarnation's start (the group's error, the engine's verdict, "
          f"the re-form, the state sync) "
          f"{ms(g.t_kill_ns, rf0['t_body']):.1f} ms, the engine rebuilt and "
          f"the replay's first step {ms(rf0['t_body'], rf0['t_step']):.1f} "
          f"ms (host clock; the group's deadline {SG_TP_DEADLINE_S} s); "
          f"{card}")
    _sg_print_end(g, card, oracle_s, t_phase)


# The examples phase (phase 15): the flagship at its full width and depth
# for EX_LM_STEPS steps, the synthetic benchmark at batch 32 for EX_RN_ARGS'
# short schedule, the serving selftest's EX_SERVE_REQUESTS requests (seeded
# prompts whose replies differ) on the flagship in bf16; each script under
# EX_TIMEOUT_S.
EX_LM_STEPS, EX_SERVE_REQUESTS, EX_TIMEOUT_S = 6, 8, 180
EX_WIDTH_ARGS = ["--d-model", "1024", "--n-layers", "8", "--n-heads", "16",
                 "--d-ff", "4096", "--vocab-size", "32768"]
EX_LM_ARGS = EX_WIDTH_ARGS + ["--seq-len", "1024", "--batch-size", "8",
                              "--steps", str(EX_LM_STEPS)]
EX_SERVE_ARGS = EX_WIDTH_ARGS + ["--bf16", "--selftest",
                                 str(EX_SERVE_REQUESTS)]
EX_RN_ARGS = ["--batch-size", "32", "--num-warmup-batches", "3",
              "--num-batches-per-iter", "5", "--num-iters", "3"]


def run_examples(card, device=None, lm_args=EX_LM_ARGS, rn_args=EX_RN_ARGS,
                 serve_args=EX_SERVE_ARGS):
    """Phase 15 (see the module docstring).  ``device`` is passed to every
    script (None: their default, the card); a rehearsal on the CPU passes
    ``"cpu"`` and narrower arguments."""
    import tempfile

    here = os.path.dirname(os.path.abspath(__file__))
    ex = os.path.join(here, "examples", "torch_port")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("HVD_", "MASTER_", "HOROVOD_"))}
    env["PYTHONPATH"] = here + os.pathsep + env.get("PYTHONPATH", "")
    want = "cuda:0" if device is None else device
    if want.startswith("cuda"):
        import torch

        want_name = torch.cuda.get_device_name(0)
    else:
        want_name = "cpu"
    dev_args = [] if device is None else ["--device", device]
    t_phase = time.perf_counter()
    outs = {}
    with tempfile.TemporaryDirectory(prefix="hvd-examples-") as tmp:
        env["HVD_BLACKBOX_DIR"] = os.path.join(tmp, "blackbox")
        for script, args in (
                ("transformer_lm.py", lm_args),
                ("pytorch_synthetic_benchmark.py", rn_args),
                ("serve_lm.py", serve_args)):
            cmd = [sys.executable, "-m", "horovod_tpu_torch.runner.run",
                   "-np", "1", "--", sys.executable,
                   os.path.join(ex, script)] + args + dev_args
            t0 = time.perf_counter()
            try:
                p = subprocess.run(cmd, env=env, cwd=tmp,
                                   capture_output=True, text=True,
                                   timeout=EX_TIMEOUT_S)
                rc, out = p.returncode, p.stdout + p.stderr
            except subprocess.TimeoutExpired as e:
                rc = "timeout"
                out = (e.stdout or b"").decode(errors="replace") \
                    if isinstance(e.stdout, bytes) else (e.stdout or "")
            wall = time.perf_counter() - t0
            outs[script] = out
            for line in out.splitlines():
                if "[0]<stdout>" in line or "Error" in line:
                    print(f"examples: {script}: {line}")
            bad = []
            if rc != 0:
                bad.append(f"exit {rc}")
            losses = [float(v) for v in re.findall(
                r"loss (\S+?)(?:\s|$)", out)]
            if script != "serve_lm.py" and not losses:
                bad.append("no loss printed")
            if not all(math.isfinite(v) for v in losses):
                bad.append(f"non-finite loss among {losses}")
            if want not in out or want_name not in out:
                bad.append(f"no report of {want} ({want_name})")
            if script == "serve_lm.py" and \
                    "replies equal to DecodeEngine's alone" not in out:
                bad.append("no selftest verdict")
            _fail_if(bad, f"examples: {script}")
            print(f"examples: {script} passed in {wall:.1f} s of wall time "
                  f"(launcher and process start included); {card}")

    lm = outs["transformer_lm.py"]
    launches = json.loads(re.search(r"flash kernel launches: (\{.*\})",
                                    lm).group(1).replace("'", '"'))
    if want.startswith("cuda") and not all(
            launches[k] > 0 for k in ("fwd", "dq", "dkv")):
        raise AssertionError(f"examples: transformer_lm.py launched "
                             f"{launches} flash kernels")
    step = re.search(r"([\d.]+) tokens/sec, step median ([\d.]+) ms", lm)
    img = re.search(r"Img/sec per device: ([\d.]+) \+-([\d.]+)",
                    outs["pytorch_synthetic_benchmark.py"])
    print(f"examples: transformer_lm.py at the flagship's width "
          f"({' '.join(lm_args)}): step median {step.group(2)} ms (host "
          f"clock, the first step included), {step.group(1)} tokens/s, "
          f"flash launches {launches}; {card}")
    print(f"examples: pytorch_synthetic_benchmark.py "
          f"({' '.join(rn_args)}): {img.group(1)} +-{img.group(2)} Img/sec "
          f"per device; {card}")
    print(f"examples: phase wall time {time.perf_counter() - t_phase:.1f} s; "
          f"{card}")


def run_ctrl_sim(card):
    """The control plane's scale harness (``horovod_tpu_torch.ctrl_sim``)
    on this machine's host: ``run_curve`` at 8, 64 and 256 in-process
    ranks, star and tree; no card involved."""
    from horovod_tpu_torch import ctrl_sim

    t0 = time.perf_counter()
    curve = ctrl_sim.run_curve(sizes=ctrl_sim.CURVE_SIZES)
    print(f"ctrl_sim: run_curve {json.dumps(curve)} on this host's "
          f"{os.cpu_count()} CPUs in {time.perf_counter() - t0:.1f} s "
          f"(host clock); {card}")
    if not curve["coordination_cycle_p50_us"] > 0:
        raise AssertionError(f"ctrl_sim: no curve: {curve}")


def serve_gang_rank(tmp: str) -> int:
    """One rank of the serving gang (``--serve-gang-rank``), started by the
    port's launcher.  Writes ``pid<r>``, and ``port<r>`` once its door
    listens (the leader's once its address is published); its timeline
    and its trace go under ``tmp`` by launch rank.  When ``dumpA`` appears
    it flushes its trace and reports its peak memory (``A<r>.json``), and
    again at the end (``final<r>.json``).  The leader stops the loop when
    ``stop`` appears."""
    import threading

    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.basics import resolve_device
    from horovod_tpu_torch.models import transformer as tfm
    from horovod_tpu_torch.serving import ServingLoop
    from horovod_tpu_torch.telemetry import trace

    p = os.path.join
    rank = int(os.environ["HVD_RANK"])  # the launch rank, kept
    os.environ["HVD_TIMELINE"] = p(tmp, f"timeline{rank}.json")
    os.environ["HVD_TRACE_DIR"] = p(tmp, f"trace{rank}")
    _sg_write(p(tmp, f"pid{rank}"), str(os.getpid()))
    with open(p(tmp, "config.json")) as fh:
        conf = json.load(fh)
    fields = dict(conf["cfg"])
    fields["compute_dtype"] = getattr(torch, fields["compute_dtype"])
    cfg = tfm.TransformerConfig(**fields)
    # No device: each rank on its own card.
    dev = (torch.device(conf["device"]) if conf["device"] else
           resolve_device(None, "serve gang"))
    if dev.type == "cpu":
        torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    model = tfm.init(0, cfg, device=dev)

    def report(name, **extra):
        peak = (torch.cuda.max_memory_allocated(dev)
                if dev.type == "cuda" else None)
        _sg_write(p(tmp, f"{name}{rank}.json"), json.dumps(
            dict(extra, rank=rank, peak_bytes=peak)))

    tp = conf.get("tp", 1)

    class Loop(ServingLoop):
        """Notes, in ``reform<r>.json``, when the first re-formed
        incarnation's body starts (the failure detected, the gang
        re-formed, the state synced) and when its first step ends, with its
        tp, and times the re-formed incarnations' steps (``b_steps``): a
        gang of one, which a lone survivor is, writes no trace."""

        t_body = None
        b_steps = []

        def _epoch_body(self, state):
            if self.t_body is None and \
                    int(os.environ.get("HVD_ELASTIC_EPOCH", "0")) > 0:
                self.t_body = time.monotonic_ns()
            return super()._epoch_body(state)

        def _apply_frame(self, frame, eng, engine, *, rank0):
            t = time.perf_counter()
            done = super()._apply_frame(frame, eng, engine, rank0=rank0)
            if self.t_body is not None:
                if self._slots:
                    self.b_steps.append((time.perf_counter() - t) * 1e3)
                if not os.path.exists(p(tmp, f"reform{rank}.json")):
                    _sg_write(p(tmp, f"reform{rank}.json"), json.dumps(
                        {"t_body": self.t_body,
                         "t_step": time.monotonic_ns(), "tp": self.tp}))
            return done

    def make_loop(door):
        return Loop(model, cfg, device=dev, port=0, host="127.0.0.1",
                    cache_len=conf["cache"], request_timeout_s=300.0,
                    mesh={"tp": tp} if tp > 1 else None,
                    on_ready=lambda port: _sg_write(
                        p(tmp, f"{door}{rank}"), str(port)))

    # The tp gang's first loop stops at stopA, its second at stop.
    live = {"loop": make_loop("port"), "stop": "stopA" if tp > 1 else "stop"}

    def watch():
        dumped = False
        while True:
            if not dumped and os.path.exists(p(tmp, "dumpA")):
                tr = trace.get()
                if tr is not None:
                    tr.flush()  # A's spans on disk before a rank dies
                report("A")
                dumped = True
            loop = live["loop"]
            if live["stop"] and os.path.exists(p(tmp, live["stop"])) and \
                    loop.scheduler is not None:
                loop.stop()
                if live["stop"] == "stop":
                    return
                live["stop"] = None  # until the second loop
            time.sleep(0.01)

    threading.Thread(target=watch, daemon=True).start()
    print(f"serve gang rank {rank}: pid {os.getpid()} on {dev}", flush=True)
    live["loop"].run()
    if tp > 1:
        oracle = _sg_tp_oracle(live["loop"], conf, dev)
        if rank == 0:
            _sg_write(p(tmp, "oracle.json"), json.dumps(oracle))
        live["loop"] = make_loop("portB")
        live["stop"] = "stop"
        live["loop"].run()
    print("DONE", flush=True)
    report("final", b_steps_ms=Loop.b_steps)
    hvd.shutdown()
    return 0


def _sg_step_ms(engine, reqs, dev):
    """The median of SG_TP_STEPS decode steps of ``engine`` with every
    slot live, the first prompts of ``reqs`` prefilled into the idle slots
    and three steps run first: host ms, each step ending with its tokens
    on the host.  The slots stay live."""
    import torch

    if not int(engine.pos.max()):
        for s, (pr, _m) in enumerate(reqs[:engine.max_batch]):
            engine.prefill(s, pr)
        for _ in range(3):
            engine.step()
    out = []
    for _ in range(SG_TP_STEPS):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t = time.perf_counter()
        engine.step()  # the tokens reach the host: synchronized
        out.append((time.perf_counter() - t) * 1e3)
    return statistics.median(out)


def _sg_tp_oracle(loop, conf, dev):
    """The tp gang's oracle, on every rank after its first loop stopped:
    ``DecodeEngine`` over the loop's mesh and this rank's shard, each
    prompt of ``conf["reqs"]`` decoded alone; then SG_TP_STEPS steps with
    every slot live, timed plain, and as many with each tp collective
    (``torch.distributed``'s ``all_reduce`` and ``all_gather``) timed
    between two synchronizations of the card."""
    import torch
    import torch.distributed as dist

    from horovod_tpu_torch.serving import DecodeEngine

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    t0 = time.perf_counter()
    mesh, shard = loop._incarnation_mesh()
    engine = DecodeEngine(shard, loop.cfg, max_batch=SERVE_SLOTS,
                          cache_len=conf["cache"], mesh=mesh, device=dev)
    tokens = [_engine_alone(engine, pr, m)[0] for pr, m in conf["reqs"]]
    oracle_s = time.perf_counter() - t0
    step_ms = _sg_step_ms(engine, conf["reqs"], dev)
    spent, calls = [0.0], [0]
    plain = {"all_reduce": dist.all_reduce, "all_gather": dist.all_gather}

    def timed(fn):
        def run(*args, **kwargs):
            sync()
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            sync()
            spent[0] += time.perf_counter() - t
            calls[0] += 1
            return out
        return run

    for name, fn in plain.items():
        setattr(dist, name, timed(fn))
    try:
        timed_step_ms = _sg_step_ms(engine, conf["reqs"], dev)
    finally:
        for name, fn in plain.items():
            setattr(dist, name, fn)
    return {"tokens": tokens, "step_ms": step_ms,
            "timed_step_ms": timed_step_ms,
            "coll_ms": spent[0] * 1e3 / SG_TP_STEPS,
            "collectives": calls[0] // SG_TP_STEPS, "oracle_s": oracle_s}


def run_audit(hvd, tfm, make_mesh, dev, card):
    """``fingerprint`` over the flagship's training state after one step
    (``train.state_tree``: the parameters and AdamW's two moments), timed;
    at one rank ``audit_replicas`` must return its folded digest."""
    import torch

    from horovod_tpu_torch.integrity import audit
    from horovod_tpu_torch.parallel import train

    cfg = _flagship_cfg(tfm)
    step_fn, init_fn = hvd.make_transformer_train_step(cfg, mesh=make_mesh())
    state = init_fn(0)
    gen = torch.Generator(device=dev).manual_seed(9)
    tokens = torch.randint(0, cfg.vocab_size, (8, 1024), device=dev,
                           generator=gen)
    state, _ = step_fn(state, tokens, torch.roll(tokens, -1, dims=1))
    tree = train.state_tree(state)
    nbytes = sum(t.nbytes for _, t in audit._leaves(tree)
                 if isinstance(t, torch.Tensor))
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        folded, per_leaf = audit.fingerprint(tree)
        times.append(time.perf_counter() - t0)
    agreed = audit.audit_replicas(tree)
    s = statistics.median(times)
    print(f"audit: fingerprint of the flagship's training state "
          f"({len(per_leaf)} leaves, {nbytes} bytes = "
          f"{nbytes / 2**30:.3f} GiB) in {s:.3f} s: "
          f"{nbytes / 2**30 / s:.3f} GiB/s (median of 3); audit_replicas "
          f"at one rank {agreed:016x}, fingerprint {folded:016x}; {card}")
    if agreed != folded:
        raise AssertionError("audit: audit_replicas does not return the "
                             "folded digest at one rank")


def _timed_steps(step_fn, state, images, labels, n):
    """``n`` steps, each timed on the host clock between two
    synchronizations: (state, times in ms, losses)."""
    import torch

    times, losses = [], []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = step_fn(state, images, labels)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    return state, times, losses


def _rel_gap(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


def run_resnet(hvd, rn, fa, make_mesh, dev, card):
    """The ResNet-50 slice: five steps of ``make_resnet_train_step_hvd``
    (``Compression.none``) through ``mesh=make_mesh(), axis=("dp",)`` at
    full width and depth, whose step-0 loss must be the no-mesh step's bit
    for bit, beside an fp32 twin's first step from the same seed, three
    steps with ``Compression.fp16``, then ten timed steps.  Returns what
    :func:`profile_resnet` needs."""
    import dataclasses

    import torch

    cfg = rn.resnet50_config()  # blocks (3, 4, 6, 3), width 64, bf16
    B, steps = 32, 5
    gen = torch.Generator(device=dev).manual_seed(2)
    images = torch.rand(B, 224, 224, 3, device=dev, generator=gen)
    labels = torch.randint(0, cfg.num_classes, (B,), device=dev,
                           generator=gen)

    def sgd(params):  # bench.py's optimizer for the ResNet-50 step
        return torch.optim.SGD(params, lr=0.01, momentum=0.9)

    mesh = make_mesh()
    step_fn, init_fn = hvd.make_resnet_train_step_hvd(cfg, sgd, mesh=mesh,
                                                      axis=("dp",))
    twin_step, twin_init = hvd.make_resnet_train_step_hvd(
        dataclasses.replace(cfg, compute_dtype=torch.float32), sgd)
    # The same step built without a mesh, from the same seed.
    no_mesh_step, no_mesh_init = hvd.make_resnet_train_step_hvd(cfg, sgd)
    _, _, no_mesh_loss = _timed_steps(no_mesh_step, no_mesh_init(0), images,
                                      labels, 1)
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    state = init_fn(0)
    state, times, losses = _timed_steps(step_fn, state, images, labels, 1)
    twin = twin_init(0)
    twin, _, twin_losses = _timed_steps(twin_step, twin, images, labels, 1)
    gaps = {}
    for (name, p), (_, t) in zip(state.model.named_parameters(),
                                 twin.model.named_parameters()):
        key = name.split(".")[-1]
        gaps[key] = max(gaps.get(key, 0.0), _rel_gap(p.grad, t.grad))
    stats = {k: _rel_gap(getattr(state.model.stem_bn, k),
                         getattr(twin.model.stem_bn, k))
             for k in ("mean", "var")}
    del twin
    state, more, more_losses = _timed_steps(step_fn, state, images, labels,
                                            steps - 1)
    times += more
    losses += more_losses
    counts = dict(fa.launches)

    bad = []
    loss_gap = abs(losses[0] - twin_losses[0])
    print(f"resnet50: losses {losses}")
    print(f"resnet50: step built with mesh {mesh.shape}, axis ('dp',): "
          f"step-0 loss {losses[0]!r}, without a mesh {no_mesh_loss[0]!r}")
    if losses[0] != no_mesh_loss[0]:
        bad.append("the step through make_mesh() moves the step-0 loss")
    print(f"resnet50: step-0 loss {losses[0]:.6f}, fp32 twin "
          f"{twin_losses[0]:.6f}, gap {loss_gap:.3e} (tol {RESNET_LOSS_TOL})")
    grad_tol = {k: RESNET_GRAD_TOL.get(k, RESNET_GRAD_TOL_BODY)
                for k in gaps}
    print("resnet50: step-0 gradient gap to the fp32 twin, largest over "
          "layers (tol): " + ", ".join(f"{k} {v:.2e} ({grad_tol[k]:g})"
                                       for k, v in gaps.items()))
    print(f"resnet50: stem batch norm after step 0, gap to the fp32 twin: "
          f"mean {stats['mean']:.2e}, var {stats['var']:.2e} "
          f"(tol {RESNET_STATS_TOL['mean']}, {RESNET_STATS_TOL['var']})")
    print(f"resnet50: flash kernel launches on this path {counts} (none "
          "expected: the CNN path runs no TPU kernel's port)")
    if not all(math.isfinite(x) for x in losses):
        bad.append(f"non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        bad.append(f"loss did not fall over {steps} steps")
    if loss_gap > RESNET_LOSS_TOL:
        bad.append("step-0 loss disagrees with the fp32 twin")
    if not all(gaps[k] <= grad_tol[k] for k in gaps):
        bad.append("step-0 gradients disagree with the fp32 twin")
    if any(stats[k] > RESNET_STATS_TOL[k] for k in stats):
        bad.append("stem batch-norm statistics disagree with the fp32 twin")
    if any(counts.values()):
        bad.append(f"flash kernels launched on the CNN path: {counts}")

    fp16_step, fp16_init = hvd.make_resnet_train_step_hvd(
        cfg, sgd, compression=hvd.Compression.fp16)
    _, _, fp16_losses = _timed_steps(fp16_step, fp16_init(0), images, labels,
                                     3)
    print(f"resnet50: Compression.fp16 losses {fp16_losses}")
    if not (all(math.isfinite(x) for x in fp16_losses)
            and fp16_losses[-1] < fp16_losses[0]):
        bad.append(f"Compression.fp16 losses not finite and falling: "
                   f"{fp16_losses}")
    _fail_if(bad, "resnet50")

    state, times, timed_losses = _timed_steps(step_fn, state, images, labels,
                                              2 * steps)
    step_ms = statistics.median(times)
    print(f"resnet50: step times alone, ms {times}; losses {timed_losses}")
    print(f"resnet50: median step {step_ms:.2f} ms, "
          f"{B / step_ms * 1e3:.1f} images/s on {card}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return step_fn, state, images, labels, step_ms


def profile_resnet(step_fn, state, images, labels, step_ms, card):
    """One ResNet-50 step under ``torch.profiler`` (after every timed step
    of the script, so that no profiler runs before one)."""
    import torch

    torch.cuda.reset_peak_memory_stats()
    _, rows = _profile_step(step_fn, state, images, labels, step_ms,
                            what="resnet50 profile")
    busy_ms = sum(_dev_us(e) for e in rows) / 1e3
    launches = sum(e.count for e in rows)
    conv = [e for e in rows if re.search(CONV_KERNELS, e.key)]
    print(f"resnet50 profile: convolutions and matrix products (cuDNN, "
          f"cuBLAS) {sum(_dev_us(e) for e in conv) / 1e3:.2f} ms in "
          f"{sum(e.count for e in conv)} launches; everything else "
          f"(batch norm, ReLU, residual adds, casts, pooling, SGD) "
          f"{sum(_dev_us(e) for e in rows if e not in conv) / 1e3:.2f} ms "
          f"in {sum(e.count for e in rows if e not in conv)}")
    print(f"resnet50 profile: {launches} launches per step, device busy "
          f"{busy_ms:.2f} ms of the {step_ms:.2f} ms median "
          f"({images.shape[0] / step_ms * 1e3:.1f} images/s), idle "
          f"{100 * (1 - busy_ms / step_ms):.1f}%; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {card}")


def _profile_rows(fn, reps, warmup=2):
    """The device kernels that ``reps`` calls of ``fn`` launch, under
    ``torch.profiler`` (see :func:`_kernel_rows`)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return _kernel_rows(prof)


def _ring_counts(fa, n, causal):
    """The launches of each kernel variant that one ring layer's forward
    and backward make over ``n`` virtual ranks: per rank one causal
    self-block and ``n - 1`` other hops (all run, the future ones
    discarded by their lse), or ``n`` non-causal hops; and one split of
    each hop's fp32 dO."""
    import torch

    want = {"split": n * n}
    for k in ("fwd", "dq", "dkv"):
        for c, times in ((True, n * causal), (False, n * (n - causal))):
            if times:
                want[fa.variant(k, torch.bfloat16, torch.float32, c,
                                out_f32=(k == "fwd"))] = times
    return want


def run_sp(fa, ra, dev, card):
    """Ring and Ulysses attention at the flagship's width over a global
    sequence of SP_RANKS x S_local, each virtual rank in turn through the
    loopback, causal and not, against ``flash_attention`` over the whole
    sequence (its forward and backward with the same dO); counts the
    kernel launches of each ring run and times one ring layer.  Returns
    {run name: its launches by kernel variant}."""
    import torch

    B, S, H, D = (SP_SHAPE[k] for k in ("B", "S_local", "H", "D"))
    n = SP_RANKS
    gen = torch.Generator(device=dev).manual_seed(4)
    q, k, v, do = (torch.randn(B, n * S, H, D, device=dev, generator=gen)
                   .to(torch.bfloat16) for _ in range(4))
    qkv = [t.requires_grad_() for t in (q, k, v)]
    print(f"sp: B {B}, {n} virtual ranks x S {S} = {n * S}, H {H}, D {D}, "
          "bf16, against flash_attention over the whole sequence")
    bad, out = [], {}
    for causal in (True, False):
        want = fa.flash_attention(q, k, v, causal=causal)
        want = (want.detach(),) + torch.autograd.grad(want, qkv, do)
        for impl in ("ring", "ulysses"):
            name = f"{impl} {'causal' if causal else 'non-causal'}"
            fa.reset_launch_counts()
            got = ra.loopback_attention(q, k, v, n, impl, causal)
            got = (got.detach(),) + torch.autograd.grad(got, qkv, do)
            torch.cuda.synchronize()
            counts = dict(fa.variant_launches)
            gaps = {t: _rel_gap(a, b)
                    for t, a, b in zip(("o", "dq", "dk", "dv"), got, want)}
            errs = {t: float((a.float() - b.float()).abs().max())
                    for t, a, b in zip(("o", "dq", "dk", "dv"), got, want)}
            print(f"sp: {name}: |got - want| / |want| "
                  + ", ".join(f"{t} {g:.3e}" for t, g in gaps.items())
                  + f" (tol {SP_TOL[impl]}); max abs err "
                  + ", ".join(f"{t} {e:.3e}" for t, e in errs.items()))
            print(f"sp: {name}: launches {counts}")
            if max(gaps.values()) > SP_TOL[impl]:
                bad.append(f"{name} disagrees with flash attention")
            want_counts = (_ring_counts(fa, n, causal) if impl == "ring"
                           else {})
            if counts != want_counts:
                bad.append(f"{name} launches {counts} != {want_counts}")
            out[name] = counts
        del want
    _fail_if(bad, "sp")

    def layer(impl):
        def run():
            o = (fa.flash_attention(q, k, v, causal=True) if impl == "flash"
                 else ra.loopback_attention(q, k, v, n, impl, True))
            torch.autograd.grad(o, qkv, do)
        return run

    reps = 5
    whole = sum(_dev_us(e) for e in _profile_rows(layer("flash"), reps)
                ) / reps / n / 1e3
    rows = _profile_rows(layer("ring"), reps)

    def per_rank(pattern):
        return sum(_dev_us(e) for e in rows
                   if re.search(pattern, e.key)) / reps / n / 1e3

    total = per_rank(".")
    bwd = per_rank(r"\b(dq|dkv)_wgmma_kernel<\d+, true, false>")
    split = per_rank(r"\bsplit_kernel<2>")
    fwd = per_rank(r"\bfwd_wgmma_kernel<")
    uly = sum(_dev_us(e) for e in _profile_rows(layer("ulysses"), reps)
              ) / reps / n / 1e3
    print(f"sp: causal ring layer, forward and backward, per virtual rank: "
          f"{total:.3f} ms of device time, of which the fp32-dO dQ and "
          f"dK/dV {bwd:.3f} ms and the dO split {split:.3f} ms (the "
          f"backward kernels {100 * (bwd + split) / total:.1f}%) and the "
          f"forward {fwd:.3f} ms; Ulysses {uly:.3f} ms; a quarter of the "
          f"flash kernels over the whole sequence {whole:.3f} ms; {card}")
    for e in rows[:8]:
        print(f"sp:   {_dev_us(e) / reps / n / 1e3:8.3f} ms  "
              f"x{e.count / reps / n:<5g} {e.key[:90]}")
    return out


def run_mnist(hvd, dev):
    """Five steps of ``make_mnist_train_step`` (Adam(1e-3), bf16) on 64
    images: the losses must be finite and fall."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(3)
    images = torch.rand(64, 28, 28, 1, device=dev, generator=gen)
    labels = torch.randint(0, 10, (64,), device=dev, generator=gen)
    step_fn, init_fn = hvd.make_mnist_train_step()
    _, times, losses = _timed_steps(step_fn, init_fn(0), images, labels, 5)
    print(f"mnist: losses {losses}; step times ms {times}")
    if not (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]):
        raise AssertionError(f"mnist: losses not finite and falling: {losses}")


# The estimator phase (14): the fitted weights of the two ranks on cuda:0
# against the same fit's on the CPU, as the largest |got - want|.  The
# first reading was 5.960e-08 (one float32 ulp of a weight between 0.5
# and 1; the losses agree to the last digit in three epochs of four) on an
# NVIDIA H100 80GB HBM3 at 700.00 W; the bound is about twice that.
EST_PARAM_TOL = 1.2e-7
EST_EPOCHS = 4


def _est_fit(device, store, notes):
    """``tests/test_spark.py``'s TorchEstimator fit through the port's
    launcher on ``device``; each rank appends the device of its first
    loss's inputs to the file ``notes``."""
    import numpy as np
    import pandas as pd
    import torch

    from horovod_tpu_torch.spark import LocalBackend, TorchEstimator

    def noted_mse(pred, target):
        if not getattr(noted_mse, "done", False):
            noted_mse.done = True
            with open(notes, "a") as fh:
                fh.write(f"{os.getpid()} {pred.device} {target.device}\n")
        return torch.nn.functional.mse_loss(pred, target)

    rs = np.random.RandomState(3)
    X = rs.randn(256, 6).astype(np.float32)
    w = rs.randn(6, 1).astype(np.float32)
    y = (X @ w).ravel()
    df = pd.DataFrame({"features": list(X), "label": y})
    torch.manual_seed(0)
    model = torch.nn.Linear(6, 1)
    est = TorchEstimator(
        model, optimizer=torch.optim.SGD(model.parameters(), lr=0.05),
        loss=noted_mse, feature_cols=["features"], label_cols=["label"],
        batch_size=32, epochs=EST_EPOCHS, num_proc=2, store=store,
        backend=LocalBackend(2, device=device), run_id=f"est-{device}")
    t0 = time.perf_counter()
    fitted = est.fit(df)
    return fitted, time.perf_counter() - t0


def run_estimator(card):
    """Phase 14 (see the module docstring)."""
    import tempfile

    import numpy as np

    from horovod_tpu_torch.spark.store import Store

    import threading

    failures = []
    with tempfile.TemporaryDirectory() as tmp:
        store = Store.create(os.path.join(tmp, "store"))
        fits, notes = {}, {}

        def fit(device):
            try:
                fits[device] = _est_fit(device, store,
                                        os.path.join(tmp, f"notes-{device}"))
            except Exception as e:  # raised below, in this thread
                fits[device] = e

        # The two fits at once: each launches its own ranks.
        threads = [threading.Thread(target=fit, args=(d,))
                   for d in ("cuda:0", "cpu")]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for device, got in fits.items():
            if isinstance(got, Exception):
                raise AssertionError(f"estimator: the {device} fit "
                                     f"failed: {got!r}") from got
            with open(os.path.join(tmp, f"notes-{device}")) as fh:
                notes[device] = sorted(ln.split()[1:] for ln in fh)
    (card_fit, card_s), (cpu_fit, cpu_s) = fits["cuda:0"], fits["cpu"]
    want = {"cuda:0": [["cuda:0", "cuda:0"]] * 2,
            "cpu": [["cpu", "cpu"]] * 2}
    for device in fits:
        if notes[device] != want[device]:
            failures.append(f"estimator: the {device} fit's ranks noted "
                            f"{notes[device]}")
    hist = card_fit.history
    if not (len(hist) == EST_EPOCHS and all(map(math.isfinite, hist))
            and hist[-1] < 0.5 * hist[0]):
        failures.append(f"estimator: the card's losses {hist} are not "
                        "finite and falling under half")
    gap = max(float(np.max(np.abs(a.numpy() - b.numpy())))
              for a, b in zip(card_fit.getModel().state_dict().values(),
                              cpu_fit.getModel().state_dict().values()))
    if not gap <= EST_PARAM_TOL:
        failures.append(f"estimator: the fitted weights are {gap:.3e} from "
                        f"the CPU fit's (bound {EST_PARAM_TOL:g})")
    print(f"estimator: TorchEstimator.fit on two ranks sharing cuda:0 "
          f"{card_s:.1f} s, on the CPU {cpu_s:.1f} s at the same time (each "
          f"launch and materialization included); losses {hist} against "
          f"{cpu_fit.history}; fitted weights {gap:.3e} from the CPU "
          f"fit's; {card}")
    _fail_if(failures, "estimator")


# {mangled kernel name: registers a thread}, from the build's ptxas report.
# The eager-engine phase: two ranks (child processes of this script, both
# on cuda:0) train the flagship through the engine, held against the
# one-process step on all of the batch's rows.  ENGINE_LOSS_TOL holds the
# step-0 loss (the mean of the ranks' losses on four rows each) against the
# one-process loss on eight, ENGINE_GRAD_TOL each parameter's averaged
# step-0 gradient and ENGINE_PARAM_TOL each parameter after the steps, as
# |got - want| / |want|.  The first H100 run read 0.0, 2.350e-03 and
# 8.730e-03 (PERF.md); each bound is about twice that (for the loss, two
# fp32 ulps of it).  Four rows' sums and eight rows' differ in the order of
# the fp32 sums and the bf16 roundings they feed; AdamW's first updates
# are about the learning rate times sign(g) whatever |g| is, so an element
# whose gradient is near zero moves by up to twice that between the two.
ENGINE_RANKS = 2
ENGINE_STEPS = 3
ENGINE_LOSS_TOL = 2e-6
ENGINE_GRAD_TOL = 5e-3
ENGINE_PARAM_TOL = 2e-2
# The engine's fusion threshold (HVD_FUSION_THRESHOLD's default).
ENGINE_FUSION_BYTES = 64 * 1024 * 1024
ENGINE_TIMEOUT_S = 600


# The telemetry phase: the engine phase's two ranks train the flagship for
# TEL_STEPS steps with every observability knob on: the autotuner (warmup 1,
# TEL_SAMPLES samples of TEL_SAMPLE_S each, then it settles; its log in the
# phase's directory), the metrics (each rank's debug server, its JSONL
# flusher and KV publication every second, rank 0's gang fold every half
# second), the trace (both ranks' span files, clock pings every 20 cycles)
# and the flight recorder.  After the steps both ranks wait TEL_SETTLE_S
# (flushes and folds land), record their own snapshots, and rank 0 scrapes
# its /gang/metrics.json.
# Each step's averaged gradient is held to ENGINE_GRAD_TOL against the
# one-process gradient on all the rows at the ranks' own parameters (bit
# for bit the same on both ranks), computed on rank 0 before its update:
# the gradients stay right at every step, and the parameters drift from
# the one-process trajectory only as AdamW carries the fp32 sums' order
# forward.  So a longer trajectory gets its own parameter bound, about
# twice a reading: ten steps read 1.787e-2 on an NVIDIA H100 80GB HBM3 at
# 700.00 W (PR 15's chip run 1), against ENGINE_PARAM_TOL's three steps.
TEL_STEPS = 10
TEL_PARAM_TOL = 3.6e-2
TEL_SAMPLES = 5
TEL_SAMPLE_S = 0.3
TEL_SETTLE_S = 2.5


def _tel_env(tmp, sample_s):
    return {"HVD_AUTOTUNE": "1", "HVD_AUTOTUNE_WARMUP_SAMPLES": "1",
            "HVD_AUTOTUNE_MAX_SAMPLES": str(TEL_SAMPLES),
            "HVD_AUTOTUNE_SAMPLE_DURATION_SECONDS": str(sample_s),
            "HVD_AUTOTUNE_LOG": os.path.join(tmp, "autotune.csv"),
            # Rank 1 binds the next port; if it is taken, that rank runs
            # without a server (a warning) and the fold still reads the KV.
            "HVD_METRICS_PORT": str(_free_port()),
            "HVD_METRICS_INTERVAL": "1", "HVD_AGG_INTERVAL": "0.5",
            "HVD_TRACE": "1", "HVD_TRACE_DIR": os.path.join(tmp, "trace"),
            "HVD_TRACE_CLOCK_SYNC_CYCLES": "20"}


def _trace_spans(path):
    clocks, spans = [], []
    with open(path) as fh:
        for line in fh:
            rec = json.loads(line)
            if rec["k"] == "clock":
                clocks.append(rec)
            elif rec["k"] == "span":
                spans.append(rec)
    return clocks, spans


def _telemetry_checks(tmp, ranks, steps, failures, card):
    """The telemetry phase's checks of what the ranks wrote (see
    TEL_STEPS): the autotuner's log and knobs, the gang fold against the
    ranks' own snapshots, the trace files and their per-step breakdown of
    ``synchronize``, and no recorder dump."""
    import csv

    n = ranks[0]["n_params"]
    # -- the autotuner
    with open(os.path.join(tmp, "autotune.csv")) as fh:
        rows = list(csv.reader(fh))
    final = rows[-1]
    print(f"telemetry: autotune log ({len(rows) - 2} samples): " + " | "
          .join(",".join(r) for r in rows[1:]))
    if final[0] != "final":
        failures.append(f"the autotune log ends in {final}, not its final "
                        "row")
    else:
        want = (int(final[2]), float(final[3]), int(final[4]),
                int(final[7]))
        for r, res in enumerate(ranks):
            k = res["knobs"]
            got = (k["fusion_threshold"], round(k["cycle_time"] * 1e3, 3),
                   int(k["cache"]), k["ring_segment_bytes"])
            print(f"telemetry rank {r}: knobs after the steps (fusion "
                  f"bytes, cycle ms, cache, segment bytes) {got}; the "
                  f"settled row {want}; by step "
                  f"{[tuple(x) for x in res['knobs_by_step']]}")
            if got != want:
                failures.append(f"rank {r}: knobs {got} != the settled "
                                f"{want}")
            if len({tuple(x) for x in res["knobs_by_step"]}) < 2:
                failures.append(f"rank {r}: no broadcast changed a knob "
                                "during the steps")
        done = [i for i, d in enumerate(ranks[0]["tuner_done"]) if d]
        print(f"telemetry: the tuner settled in step "
              f"{done[0] if done else None} of {steps}")
        if not done or done[0] > steps - 3:
            failures.append(f"the tuner settled in step "
                            f"{done[0] if done else None}, not two steps "
                            f"before the last ({steps - 1})")
    # -- the metrics: the gang fold against the ranks' own snapshots
    view = ranks[0]["gang_view"]
    key = 'hvd_collectives_total{op="allreduce",dtype="float32"}'
    own = [res["snapshot"]["counters"].get(key, 0) for res in ranks]
    folded = view["counters"].get(key, 0)
    hop = {k: h["count"] for k, h in view["histograms"].items()
           if k.startswith("hvd_ring_hop_seconds")}
    print(f"telemetry: rank 0's /gang/metrics.json: stale ranks "
          f"{view['stale_ranks']}, {key} {folded} (the ranks' own "
          f"{own}; {n} gradients x {steps} steps x {len(ranks)} ranks = "
          f"{n * steps * len(ranks)}), hvd_ring_hop_seconds samples {hop}, "
          f"p50/p99 of the collectives' latency "
          f"{[round(1e3 * h[q], 3) for k, h in view['histograms'].items() if k.startswith('hvd_collective_latency') for q in ('p50', 'p99')]}"
          f" ms")
    if view["stale_ranks"]:
        failures.append(f"the gang fold's stale ranks {view['stale_ranks']}")
    if not folded == sum(own) == n * steps * len(ranks):
        failures.append(f"the fold's {key} {folded}, the ranks' {own}, "
                        f"want {n * steps * len(ranks)}")
    if not hop or not all(hop.values()):
        failures.append(f"hvd_ring_hop_seconds has no samples: {hop}")
    # -- the trace
    seqs = {}
    for r, res in enumerate(ranks):
        clocks, spans = _trace_spans(os.path.join(
            tmp, "trace", f"trace_rank{r}.jsonl"))
        if r > 0 and not clocks:
            failures.append(f"rank {r}'s trace has no clock record")
        seqs[r] = {s["seq"]: s["name"] for s in spans
                   if s["ph"] == "collective"}
        per = {k: [] for k in ("negotiate", "pack", "hop.recv",
                               "hop.reduce", "hop.send_wait", "unpack",
                               "callback")}
        for st in res["steps"]:
            lo, hi = st["t_enq_ns"], st["t_sync_ns"]
            tot = dict.fromkeys(per, 0)
            for s in spans:
                if not lo <= s["t0"] <= hi:
                    continue
                if s["ph"] == "hop":
                    tot["hop.recv"] += s["recv_ns"]
                    tot["hop.reduce"] += s["reduce_ns"]
                    tot["hop.send_wait"] += s["send_wait_ns"]
                elif s["ph"] in tot:
                    tot[s["ph"]] += s["t1"] - s["t0"]
            for k in per:
                per[k].append(tot[k] / 1e6)
        sync = statistics.median(st["sync_ms"] for st in res["steps"])
        med = {k: round(statistics.median(v), 1) for k, v in per.items()}
        hops = med["hop.recv"] + med["hop.reduce"] + med["hop.send_wait"]
        print(f"telemetry rank {r}: a step's span sums, medians over "
              f"{steps} steps (ms): {med}; the shm ring's hops "
              f"{hops:.1f} ms of the step's synchronize {sync:.1f} ms "
              f"({100 * hops / sync:.0f}%), clock records {len(clocks)}"
              f"{', offsets (ns) ' + str([c['offset_ns'] for c in clocks[:5]]) if r else ''}; "
              f"{card}")
    if seqs[0] != seqs[1] or not seqs[0]:
        failures.append("the ranks' traces name other collectives under "
                        "one seq, or none")
    # -- the port's trace tool over the same files: the phases read above
    from horovod_tpu_torch.tools import hvd_trace

    rep = hvd_trace.analyze_dir(os.path.join(tmp, "trace"))
    named = {} if rep is None else rep["phase_breakdown_ms"]
    read = ("negotiate", "pack", "hop.recv", "hop.reduce", "hop.send_wait",
            "unpack", "callback")
    print(f"telemetry: hvd_trace analyze_dir (the port's tool) over the "
          f"trace files: {rep and rep['num_ranks']} ranks, "
          f"{rep and rep['num_collectives']} collectives, mean ms a "
          f"collective a rank {named}; {card}")
    if rep is None or rep["num_ranks"] != len(ranks) or \
            sorted(named) != sorted(read) or not named["hop.recv"] > 0:
        failures.append(f"the port's hvd_trace names {sorted(named)}, not "
                        f"the phases the checks read {sorted(read)}")
    # -- the flight recorder: a clean run dumps nothing
    bb = os.path.join(tmp, "blackbox")
    if os.path.isdir(bb) and os.listdir(bb):
        failures.append(f"the clean run dumped {os.listdir(bb)}")


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _greedy_groups(sizes, threshold):
    """How many fused responses the engine's fusion makes of tensors of
    ``sizes`` bytes that all become ready in one cycle: consecutive
    tensors while their sum stays within ``threshold``."""
    n, acc = 0, None
    for b in sizes:
        if acc is not None and acc + b <= threshold:
            acc += b
        else:
            n, acc = n + 1, b
    return n


def _spawn_ranks(flag, n, tmp, env_of, timeout, what, expect=None,
                 stalled=(), pids=None, late=None, core="py"):
    """Run ``n`` ranks of this script (``flag R tmp``) against the port's
    ``RendezvousServer``; returns each rank's (exit code, output), killing
    every rank past ``timeout``.  A rank must exit with ``expect[r]``
    (default 0); a ``stalled`` rank must still run when the others have
    exited, and is killed then.  ``pids``, a list, gets the ranks'
    process ids.  ``late``: {rank: path}, a rank that starts once the
    file ``path`` exists (an elastic joiner).  ``core``: the ranks'
    ``HVD_TPU_CORE``; the phases whose subject is a Python-engine feature
    (shm rings, the ladder, liveness, telemetry spans, the recorder,
    elastic, the front-end's fusion knob) keep the default ``"py"``, and
    None leaves ``hvd.init()`` its default, the native core."""
    from horovod_tpu_torch.runner.http_server import RendezvousServer

    server = RendezvousServer("127.0.0.1")
    port = server.start()
    base = {k: v for k, v in os.environ.items()
            if not k.startswith(("HVD_", "MASTER_", "HOROVOD_"))}
    # The flight recorder is on in every rank: its dumps go under ``tmp``
    # unless the phase names another directory.
    base["HVD_BLACKBOX_DIR"] = os.path.join(tmp, "blackbox")
    if core is not None:
        base["HVD_TPU_CORE"] = core
    procs, outs = [], []
    late = late or {}

    def start(r):
        return subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), flag, str(r), tmp],
            env=dict(base, HVD_RENDEZVOUS_ADDR="127.0.0.1",
                     HVD_RENDEZVOUS_PORT=str(port), **env_of(r)),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    try:
        deadline = time.monotonic() + timeout
        procs = [None if r in late else start(r) for r in range(n)]
        for r, path in sorted(late.items()):
            while not os.path.exists(path) and \
                    time.monotonic() < deadline and \
                    all(p is None or p.poll() is None for p in procs):
                time.sleep(0.02)
            procs[r] = start(r)
        outs = [None] * n
        wedged = []
        for r in [r for r in range(n) if r not in stalled] + list(stalled):
            p = procs[r]
            if r in stalled:
                if p.poll() is None:
                    wedged.append(r)
                p.kill()
            try:
                out, _ = p.communicate(
                    timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                out, _ = p.communicate()
                out += f"\n(killed after {timeout} s)"
            outs[r] = (p.returncode, out)
    finally:
        for p in procs:
            if p is not None and p.poll() is None:
                p.kill()
                p.wait()
        server.stop()
    for r, (code, out) in enumerate(outs):
        for line in out.splitlines():
            print(f"{what} rank {r}: {line}")
    failed = [r for r, (code, _) in enumerate(outs)
              if r not in stalled and code != (expect or {}).get(r, 0)]
    failed += [r for r in stalled if r not in wedged]
    if failed:
        raise AssertionError(f"{what}: rank(s) {failed} failed")
    if pids is not None:
        pids.extend(p.pid for p in procs)
    return outs


# The one-process reference of run_engine, by (config, steps, device):
# the phases that train the same steps share it.
_ENGINE_REFS = {}


def _engine_ref(hvd, cfg, dev, batches):
    """The one-process step on all the rows, from seed 0's weights:
    (step-0 loss, step-0 gradients, parameters after the steps), on the
    host (the card's memory stays free for the ranks)."""
    import torch

    key = (repr(cfg), len(batches), str(dev))
    with _INPROC:
        if key in _ENGINE_REFS:
            return _ENGINE_REFS[key]
        hvd.init(device=dev)
        try:
            step_fn, init_fn = hvd.make_transformer_train_step(cfg,
                                                               device=dev)
            state = init_fn(0)
            for s, (tokens, targets) in enumerate(batches):
                state, loss = step_fn(state, tokens, targets)
                if s == 0:
                    ref_loss = float(loss)
                    ref_grads = {n: p.grad.detach().cpu()
                                 for n, p in state.model.named_parameters()}
            ref_params = {n: p.detach().cpu()
                          for n, p in state.model.named_parameters()}
            del state, step_fn, init_fn
        finally:
            hvd.shutdown()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        _ENGINE_REFS[key] = (ref_loss, ref_grads, ref_params)
        return _ENGINE_REFS[key]


def run_engine(hvd, tfm, fa, dev, card, cfg=None, timeout=ENGINE_TIMEOUT_S,
               knobs=None, steps=ENGINE_STEPS, telemetry=False,
               tel_sample_s=None, native=False):
    """The eager engine on the card: ENGINE_RANKS ranks of this script
    (``--engine-rank R``) bootstrap a ``PyEngine`` through the port's
    ``RendezvousServer`` and train the flagship (``cfg``: by default the
    full-width flagship) for ``steps`` steps, each rank on its rows of the
    batch, the gradients averaged by one ``allreduce_async`` per
    parameter; held against ``make_transformer_train_step`` in this process
    on all the rows, from the same weights.  ``knobs``: more variables for
    the ranks (the liveness phase's rerun with its knobs on).
    ``telemetry``: the telemetry phase (see TEL_STEPS): the autotuner, the
    metrics with their server, flusher and gang fold, and the trace on,
    with their checks (:func:`_telemetry_checks`) in place of the default
    knobs' cache and fusion checks; ``tel_sample_s`` overrides the tuner's
    sample.  ``native``: the native phase (see NATIVE_ROUTES): the ranks
    on ``hvd.init()``'s default core, which must be the native engine,
    with the three routes' check in place of the Python engine's fusion
    log and link media."""
    what = "native" if native else "telemetry" if telemetry else \
        "engine" if not knobs else "engine (knobs on)"
    import tempfile

    import torch

    cfg = cfg or _flagship_cfg(tfm)
    B = 8
    batches = _token_batches(dev, steps, B=B, S=cfg.max_seq_len,
                             vocab=cfg.vocab_size, seed=7)
    ref_loss, ref_grads, ref_params = _engine_ref(hvd, cfg, dev, batches)

    with tempfile.TemporaryDirectory() as tmp:
        fields = {f.name: getattr(cfg, f.name)
                  for f in dataclasses.fields(cfg)}
        fields["compute_dtype"] = str(cfg.compute_dtype).split(".")[1]
        with open(os.path.join(tmp, "config.json"), "w") as fh:
            json.dump({"cfg": fields, "device": str(dev), "rows": B,
                       "steps": steps, "store_port": _free_port(),
                       "telemetry": telemetry, "grad_check": telemetry,
                       "native": native}, fh)
        env = dict(knobs or {})
        if telemetry:
            env.update(_tel_env(tmp, tel_sample_s or TEL_SAMPLE_S))
        t0 = time.perf_counter()
        _spawn_ranks("--engine-rank", ENGINE_RANKS, tmp, lambda r: dict(
            env, HVD_RANK=str(r), HVD_SIZE=str(ENGINE_RANKS),
            HVD_LOCAL_RANK=str(r), HVD_LOCAL_SIZE=str(ENGINE_RANKS),
            **({"HVD_METRICS_FILE": os.path.join(tmp, f"metrics{r}.jsonl")}
               if telemetry else {})), timeout, what,
            core=None if native else "py")
        wall = time.perf_counter() - t0
        ranks = []
        for r in range(ENGINE_RANKS):
            with open(os.path.join(tmp, f"rank{r}.json")) as fh:
                ranks.append(json.load(fh))
        got = torch.load(os.path.join(tmp, "rank0.pt"))
        failures = []
        if telemetry:
            _telemetry_checks(tmp, ranks, steps, failures, card)

    loss_gap = abs(ranks[0]["loss0_mean"] - ref_loss)
    grad_gaps = {n: float((got["grads0"][n] - g).norm()
                          / g.norm().clamp_min(1e-30))
                 for n, g in ref_grads.items()}
    param_gaps = {n: float((got["params"][n] - p).norm()
                           / p.norm().clamp_min(1e-30))
                  for n, p in ref_params.items()}
    wg = max(grad_gaps, key=grad_gaps.get)
    wp = max(param_gaps, key=param_gaps.get)
    param_tol = TEL_PARAM_TOL if telemetry else ENGINE_PARAM_TOL
    engines = sorted({tuple(r["engine"]) for r in ranks})
    print(f"{what}: {ENGINE_RANKS} ranks on {dev} through the port's "
          f"RendezvousServer and {'/'.join(e[0] for e in engines)}, "
          f"{wall:.1f} s wall; step-0 loss "
          f"(the ranks' mean) {ranks[0]['loss0_mean']!r} against one "
          f"process on all {B} rows {ref_loss!r}: gap {loss_gap:.3e} (tol "
          f"{ENGINE_LOSS_TOL}); largest |g - g_one| / |g_one| of the "
          f"averaged step-0 gradients {grad_gaps[wg]:.3e} ({wg}; tol "
          f"{ENGINE_GRAD_TOL}); largest |p - p_one| / |p_one| after "
          f"{steps} steps {param_gaps[wp]:.3e} ({wp}; tol {param_tol}); "
          f"{card}")
    want_engine = ("NativeEngine", None) if native else \
        ("PyEngine", "HVD_TPU_CORE forces the Python engine")
    if engines != [want_engine]:
        failures.append(f"the ranks' engines and fallback reasons "
                        f"{engines}, not {want_engine}")
    if not loss_gap <= ENGINE_LOSS_TOL:
        failures.append("the step-0 loss")
    if not grad_gaps[wg] <= ENGINE_GRAD_TOL:
        failures.append("the averaged step-0 gradients")
    if not param_gaps[wp] <= param_tol:
        failures.append(f"the parameters after {steps} steps")
    if telemetry:
        gaps = ranks[0]["grad_gaps"]
        print(f"{what}: each step's averaged gradients against the "
              f"one-process gradient at the ranks' parameters, largest "
              f"|g - g_one| / |g_one| by step "
              f"{[f'{g[1]:.3e}' for g in gaps]} (tol {ENGINE_GRAD_TOL})")
        if len(gaps) != steps or not all(g[1] <= ENGINE_GRAD_TOL
                                         for g in gaps):
            failures.append(f"a step's averaged gradients: {gaps}")
    want_launches = {"fwd": 2 * cfg.n_layers * steps,
                     "dq": cfg.n_layers * steps,
                     "dkv": cfg.n_layers * steps, "split": 0}
    for r, res in enumerate(ranks):
        rsteps = res["steps"]
        gbs = [round(s["grad_bytes"] / (s["enqueue_ms"] + s["sync_ms"])
                     / 1e6, 3) for s in rsteps]
        if native:
            # The core keeps no response log, and speaks TCP only.
            print(f"{what} rank {r}: step ms "
                  f"{[round(s['ms'], 1) for s in rsteps]}, median "
                  f"{statistics.median(s['ms'] for s in rsteps):.1f}; "
                  f"enqueue ms {[round(s['enqueue_ms'], 1) for s in rsteps]}"
                  f"; in synchronize ms "
                  f"{[round(s['sync_ms'], 1) for s in rsteps]}; gradient "
                  f"bytes a step {rsteps[0]['grad_bytes']}; effective GB/s "
                  f"{gbs}; cache hits "
                  f"{[s['cache']['hits'] for s in rsteps]}, misses "
                  f"{[s['cache']['misses'] for s in rsteps]}; flash "
                  f"launches {res['launches']}")
            _native_route_checks(what, r, res, failures)
        else:
            print(f"{what} rank {r}: step ms "
                  f"{[round(s['ms'], 1) for s in rsteps]}, median "
                  f"{statistics.median(s['ms'] for s in rsteps):.1f}; "
                  f"enqueue (the gradients' copies to the host) ms "
                  f"{[round(s['enqueue_ms'], 1) for s in rsteps]}; in "
                  f"synchronize ms "
                  f"{[round(s['sync_ms'], 1) for s in rsteps]}; gradient "
                  f"bytes a step {rsteps[0]['grad_bytes']}; fused "
                  f"responses {[s['responses'] for s in rsteps]} (the 64 "
                  f"MiB threshold's grouping of all {res['n_params']} "
                  f"tensors at once: {res['greedy_groups']}), largest "
                  f"{max(s['largest_response'] for s in rsteps)} bytes; "
                  f"effective GB/s (gradient bytes / time in enqueue and "
                  f"synchronize) {gbs}; cache hits "
                  f"{[s['cache']['hits'] for s in rsteps]}, misses "
                  f"{[s['cache']['misses'] for s in rsteps]}; flash "
                  f"launches {res['launches']}")
        if not res["bcast_bits_equal"]:
            failures.append(f"rank {r}: broadcast_parameters' weights are "
                            "not rank 0's bit for bit")
        if not res["params_equal_across_ranks"]:
            failures.append(f"rank {r}: the ranks' parameters differ "
                            f"after {steps} steps")
        if not res["card_tensors_equal"]:
            failures.append(f"rank {r}: card tensors through the engine "
                            f"differ from their CPU copies: "
                            f"{res['card_tensors']}")
        hits = [s["cache"]["hits"] for s in rsteps]
        misses = [s["cache"]["misses"] for s in rsteps]
        n = res["n_params"]
        # The tuner moves the cache switch and the fusion threshold: these
        # are the default knobs' checks.
        if not telemetry and (hits != [0] + [n] * (steps - 1) or
                              misses != [n] + [0] * (steps - 1)):
            failures.append(f"rank {r}: cache hits {hits} and misses "
                            f"{misses}, not every tensor cached after "
                            "step 0")
        for s in rsteps if not native else ():
            if s["fused_tensors"] != n or (not telemetry and (
                    s["responses"] < res["greedy_groups"] or
                    not s["within_threshold"])):
                failures.append(f"rank {r}: step {s['step']}'s fused "
                                "responses break the 64 MiB grouping")
        if dev.type == "cuda" and res["launches"] != want_launches:
            failures.append(f"rank {r}: flash launches {res['launches']} "
                            f"!= {want_launches}")
        if not all(math.isfinite(s["loss"]) for s in rsteps):
            failures.append(f"rank {r}: a loss is not finite")
        if native:
            continue
        print(f"{what} rank {r}: link media by peer {res['media']}")
        want_media = "tcp" if env.get("HVD_SHM_DISABLE") == "1" else "shm"
        if set(res["media"].values()) != {want_media}:
            failures.append(f"rank {r}: a same-host pair is not on "
                            f"{want_media}: {res['media']}")
    print(f"{what}: on {card}; {ranks[0]['bcast_ms']:.1f} ms to broadcast "
          f"the parameters ({ranks[0]['param_bytes']} bytes) from rank 0")
    if failures:
        raise AssertionError(f"{what}: " + "; ".join(failures))
    return ranks


def engine_rank(rank: int, tmp: str) -> int:
    """One rank of the engine phase (``--engine-rank``): its own seed's
    weights, made rank 0's by ``broadcast_parameters``; ENGINE_STEPS steps
    on its rows of the batches, one ``allreduce_async`` (Average) per
    parameter's gradient; then card tensors through the engine against
    their CPU copies.  Writes its readings to ``<tmp>/rank<r>.json`` (and
    rank 0 its averaged step-0 gradients and last parameters to
    ``rank0.pt``)."""
    import numpy as np
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import basics
    from horovod_tpu_torch.integrity.audit import fingerprint
    from horovod_tpu_torch.models import transformer as tfm
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.parallel.train import default_optimizer

    with open(os.path.join(tmp, "config.json")) as fh:
        conf = json.load(fh)
    fields = dict(conf["cfg"])
    fields["compute_dtype"] = getattr(torch, fields["compute_dtype"])
    cfg = tfm.TransformerConfig(**fields)
    dev = torch.device(conf["device"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if dev.type == "cpu":
        torch.set_num_threads(2)
    # Both ranks share one card, and NCCL refuses two ranks on one card:
    # init is asked for the device by name (not cuda:<local_rank>) and for
    # a gloo process group, which nothing here uses; the gradients go
    # through the eager engine, which needs no torch.distributed group.
    hvd.init(device=dev, backend="gloo",
             init_method=f"tcp://127.0.0.1:{conf['store_port']}")
    try:
        eng = basics._engine()
        size = hvd.size()
        model = tfm.init(rank, cfg, device=dev)  # rank 1: another seed
        names = [n for n, _ in model.named_parameters()]
        own = np.array([fingerprint(model.state_dict())[0]],
                       np.uint64).view(np.int64)
        rank0_digest = hvd.broadcast(own, root_rank=0, name="digest.seed")
        _sync_dev(torch, dev)
        t0 = time.perf_counter()
        synced = hvd.broadcast_parameters(model.state_dict(), root_rank=0)
        model.load_state_dict(synced)
        _sync_dev(torch, dev)
        bcast_ms = (time.perf_counter() - t0) * 1e3
        mine = np.array([fingerprint(model.state_dict())[0]],
                        np.uint64).view(np.int64)
        bcast_equal = bool(mine[0] == rank0_digest[0])
        del synced

        rows = slice(rank * conf["rows"] // size,
                     (rank + 1) * conf["rows"] // size)
        batches = _token_batches(dev, conf["steps"], B=conf["rows"],
                                 S=cfg.max_seq_len, vocab=cfg.vocab_size,
                                 seed=7)
        opt = default_optimizer(model.parameters())
        sizes = [p.numel() * 4 for p in model.parameters()]
        native = bool(conf.get("native"))
        # The native core keeps no response log: its fusion is not read.
        greedy = _greedy_groups(sizes, ENGINE_FUSION_BYTES if native
                                else eng.fusion_threshold)
        log = [] if native else None
        if not native:
            eng.response_log = log = []
        steps, grads0 = [], None
        knobs_by_step, tuner_done = [], []
        grad_gaps, check_launches = [], {k: 0 for k in fa.launches}
        fa.reset_launch_counts()
        for s, (tokens, targets) in enumerate(batches):
            before = hvd.cache_stats()
            _sync_dev(torch, dev)
            t0 = time.perf_counter()
            opt.zero_grad(set_to_none=True)
            loss = tfm.loss_fn(model, tokens[rows], targets[rows])
            loss.backward()
            mark = len(log)
            t1 = time.perf_counter()
            t_enq_ns = time.monotonic_ns()
            handles = [hvd.allreduce_async(p.grad, name=n, op=hvd.Average)
                       for n, p in model.named_parameters()]
            t2 = time.perf_counter()
            for (n, p), h in zip(model.named_parameters(), handles):
                p.grad = hvd.synchronize(h)
            t3 = time.perf_counter()
            t_sync_ns = time.monotonic_ns()
            if s == 0:
                grads0 = {n: p.grad.detach().to("cpu", copy=True)
                          for n, p in model.named_parameters()}
            check_s = 0.0
            if conf.get("grad_check") and rank == 0:
                # Not part of the step: its time and launches come off.
                tc = time.perf_counter()
                gap = _one_process_gap(tfm, model, tokens, targets,
                                       check_launches)
                grad_gaps.append([s, *gap])
                check_s = time.perf_counter() - tc
            opt.step()
            _sync_dev(torch, dev)
            t4 = time.perf_counter() - check_s
            fused = [e for e in log[mark:] if e[0] == "ALLREDUCE"]
            after = hvd.cache_stats()
            steps.append(dict(
                step=s, loss=float(loss.detach()), ms=(t4 - t0) * 1e3,
                backward_ms=(t1 - t0) * 1e3, enqueue_ms=(t2 - t1) * 1e3,
                sync_ms=(t3 - t2) * 1e3, grad_bytes=sum(sizes),
                cache={k: after[k] - before[k] for k in ("hits",
                                                         "misses")},
                t_enq_ns=t_enq_ns, t_sync_ns=t_sync_ns))
            if native:
                continue
            steps[-1].update(
                responses=len(fused),
                fused_tensors=sum(e[1] for e in fused),
                largest_response=max(e[2] for e in fused),
                within_threshold=all(e[1] == 1 or
                                     e[2] <= eng.fusion_threshold
                                     for e in fused))
            knobs_by_step.append(_engine_knobs(eng))
            tuner_done.append(bool(eng._pm is not None and eng._pm.done))
        tel = _telemetry_readings(hvd, eng) if conf.get("telemetry") \
            else {}
        launches = {k: n - check_launches[k] for k, n in fa.launches.items()}
        routes = _native_routes(hvd, grads0, names) if native else {}
        media = {} if native else eng.transport_media()
        if not native:
            eng.response_log = None
        loss0 = hvd.allreduce(torch.tensor([steps[0]["loss"]]),
                              op=hvd.Average, name="loss0")
        digest = np.array([fingerprint(model.state_dict())[0]],
                          np.uint64).view(np.int64)
        digests = hvd.allgather(digest, name="digest.final")

        # Card tensors through the engine against their CPU copies: the
        # same op on the same values, so the same bits, on the card.
        gen = torch.Generator().manual_seed(100 + rank)
        card = {}
        for dt in (torch.float32, torch.bfloat16):
            x = (torch.randn(4097, generator=gen) * 3).to(dt)
            xd = x.to(dev)
            tag = str(dt).split(".")[1]
            for op, fn in (
                    ("allreduce", lambda t, nm: hvd.allreduce(
                        t, op=hvd.Sum, name=nm)),
                    ("allgather", lambda t, nm: hvd.allgather(t, name=nm)),
                    ("broadcast", lambda t, nm: hvd.broadcast(
                        t, root_rank=size - 1, name=nm))):
                got = fn(xd, f"card.{op}.{tag}")
                want = fn(x, f"host.{op}.{tag}")
                bits = torch.int32 if dt == torch.float32 else torch.int16
                card[f"{op}.{tag}"] = bool(
                    got.device == dev and got.dtype == dt and
                    torch.equal(got.cpu().view(bits), want.view(bits)))
        res = dict(
            rank=rank, steps=steps, launches=launches,
            n_params=len(names), greedy_groups=greedy,
            loss0_mean=float(loss0[0]), bcast_ms=bcast_ms,
            param_bytes=sum(sizes), bcast_bits_equal=bcast_equal,
            params_equal_across_ranks=bool(len(set(digests.tolist()))
                                           == 1),
            card_tensors=card, card_tensors_equal=all(card.values()),
            media={str(p): m for p, m in media.items()},
            knobs_by_step=knobs_by_step, tuner_done=tuner_done,
            grad_gaps=grad_gaps,
            engine=[type(eng).__name__,
                    getattr(eng, "native_fallback_reason", None)],
            routes=routes, **tel)
        if rank == 0:
            torch.save({"grads0": grads0,
                        "params": {n: p.detach().cpu()
                                   for n, p in model.named_parameters()}},
                       os.path.join(tmp, "rank0.pt"))
        with open(os.path.join(tmp, f"rank{rank}.json"), "w") as fh:
            json.dump(res, fh)
    finally:
        hvd.shutdown()
    return 0


# The native phase: the engine phase's ranks on hvd.init()'s default core,
# the C++ engine (built by this process on a thread from the run's start:
# the g++ version, each library's build seconds and path are printed),
# held to the engine phase's
# bounds against the one-process step, the ranks' parameters equal bit for
# bit.  Then each rank reduces CPU copies of its step-0 gradients three
# ways, with Average: the eager engine's numpy route (``allreduce_async``
# per tensor), ``horovod_tpu_torch.torch.allreduce_`` (the dispatcher op
# ``torch.ops.hvd.allreduce_``) and the bridge's grouped allreduce compiled
# by ``torch.compile(fullgraph=True, backend="aot_eager")`` (the dispatcher
# op ``hvd::grouped_allreduce``).  NATIVE_ROUTES names them; the three must
# agree bit for bit, every dispatcher call must have gone through its op,
# and the compiled step must have no graph break.
NATIVE_ROUTES = ("numpy", "allreduce_", "bridge")


def _native_routes(hvd, grads, names):
    """The three routes of the native phase on ``grads`` (CPU tensors by
    name, in ``names``' order): each route's results' digest, its time and
    the dispatcher calls it made; the graph breaks of the compiled one."""
    import hashlib

    import torch
    from torch._dynamo.utils import counters

    import horovod_tpu_torch.torch as ht
    from horovod_tpu_torch.ops import bridge
    from horovod_tpu_torch.torch import _native_ops

    xs = [grads[n].contiguous() for n in names]

    def numpy_route():
        hs = [hvd.allreduce_async(x, op=hvd.Average, name=f"route.np.{i}")
              for i, x in enumerate(xs)]
        return [hvd.synchronize(h) for h in hs]

    def inplace_route():
        outs = [x.clone() for x in xs]
        for i, x in enumerate(outs):
            ht.allreduce_(x, op=ht.Average, name=f"route.ip.{i}")
        return outs

    # aot_eager: the same trace (dynamo, fullgraph) with no code
    # generation, whose compile the torch-api phase already times.
    compiled = torch.compile(lambda gs: bridge.grouped_allreduce(
        gs, name="route.bridge", op=hvd.Average), fullgraph=True,
        backend="aot_eager")
    counters.clear()
    # The compile, with the op's first call: the route's time is the
    # second call's.
    t0 = time.perf_counter()
    compiled(xs)
    first_ms = (time.perf_counter() - t0) * 1e3
    out = {}
    for route, fn in zip(NATIVE_ROUTES, (numpy_route, inplace_route,
                                         lambda: compiled(xs))):
        before = dict(_native_ops.dispatched)
        t0 = time.perf_counter()
        got = fn()
        ms = (time.perf_counter() - t0) * 1e3
        h = hashlib.sha256()
        for t in got:
            h.update(t.contiguous().view(torch.uint8).numpy().tobytes())
        out[route] = dict(digest=h.hexdigest(), ms=ms, tensors=len(got),
                          dispatched={k: v - before.get(k, 0) for k, v in
                                      _native_ops.dispatched.items()
                                      if v - before.get(k, 0)})
    out["bridge"]["first_ms"] = first_ms
    out["graph_breaks"] = sum(counters["graph_break"].values())
    return out


def _native_route_checks(what, r, res, failures):
    routes = res["routes"]
    n = res["n_params"]
    print(f"{what} rank {r}: the step-0 gradients ({n} tensors) reduced "
          f"three ways: " + "; ".join(
              f"{k} {routes[k]['ms']:.1f} ms, digest "
              f"{routes[k]['digest'][:16]}, dispatcher calls "
              f"{routes[k]['dispatched']}" for k in NATIVE_ROUTES)
          + f"; the compiled route's first call (its compile) "
          f"{routes['bridge']['first_ms']:.1f} ms; graph breaks "
          f"{routes['graph_breaks']}")
    want = {"numpy": {}, "allreduce_": {"allreduce_": n},
            "bridge": {"grouped_allreduce": 1}}
    if len({routes[k]["digest"] for k in NATIVE_ROUTES}) != 1:
        failures.append(f"rank {r}: the three routes' results differ")
    for k in NATIVE_ROUTES:
        if routes[k]["dispatched"] != want[k] or routes[k]["tensors"] != n:
            failures.append(f"rank {r}: the {k} route made the dispatcher "
                            f"calls {routes[k]['dispatched']}, not {want[k]}")
    if routes["graph_breaks"] != 0:
        failures.append(f"rank {r}: {routes['graph_breaks']} graph breaks")


def start_native_build():
    """Build the native core, then the dispatcher ops, on a thread (the
    compilers at a lower priority), beside the kernels' nvcc at the start
    of the run; :func:`run_native` joins it.  Returns the thread's
    record."""
    import threading

    from horovod_tpu_torch.common import native_build
    from horovod_tpu_torch.torch import _native_ops

    rec = {}

    def build():
        t0 = time.perf_counter()
        try:
            rec["core"] = native_build.build_core()
            flags, links, key = _native_ops._flags()
            rec["ops"] = native_build.build_ops(_native_ops.SRC, flags,
                                                links, key)
        except Exception as e:  # reported by run_native
            rec["error"] = e
        rec["s"] = time.perf_counter() - t0

    rec["thread"] = threading.Thread(target=build, daemon=True)
    rec["thread"].start()
    return rec


def run_native(hvd, tfm, fa, dev, card, plain, cfg=None, tcp=None,
               build=None):
    """The native phase (see NATIVE_ROUTES): the build (``build``, the
    record of :func:`start_native_build`, or here), then the ranks through
    :func:`run_engine`; prints the step, enqueue and synchronize medians
    beside ``plain``'s, the engine phase's reports (the Python engine,
    same call), and ``tcp``'s where given (the Python engine under
    ``HVD_SHM_DISABLE=1``)."""
    from horovod_tpu_torch.common import native_build
    from horovod_tpu_torch.torch import _native_ops

    gxx = _sh([native_build.cxx(), "--version"]).splitlines()[0]
    build = build or start_native_build()
    t0 = time.perf_counter()
    build["thread"].join()
    waited = time.perf_counter() - t0
    if "error" in build:
        raise AssertionError(f"native: the build failed: {build['error']}")
    ops = _native_ops.load()
    built = native_build.build_seconds
    print(f"native: build with {gxx} on a thread beside the run: the core "
          f"{built.get(os.path.basename(build['core']), 0.0):.1f} s "
          f"compiling -> {build['core']}; the dispatcher ops "
          f"{built.get(os.path.basename(ops), 0.0):.1f} s compiling -> "
          f"{ops}; {build['s']:.1f} s in all, {waited:.1f} s of it waited "
          f"for here")
    ranks = run_engine(hvd, tfm, fa, dev, card, cfg=cfg, native=True)
    for r in range(ENGINE_RANKS):
        def med(reports, k):
            return statistics.median(s[k] for s in reports[r]["steps"])

        for other, what in ((plain, "the Python engine (the engine "
                                    "phase, this call)"),
                            (tcp, "the Python engine over TCP (this "
                                  "call)")):
            if other is None:
                continue
            print(f"native rank {r}: medians on the native core / on "
                  f"{what}: " + "; ".join(
                      f"{label} {med(ranks, k):.1f} / {med(other, k):.1f} ms"
                      for label, k in (("step", "ms"),
                                       ("enqueue", "enqueue_ms"),
                                       ("synchronize", "sync_ms")))
                  + f"; {card}")
    return ranks


def _one_process_gap(tfm, model, tokens, targets, launches_taken):
    """The largest |g - g_one| / |g_one| of the model's gradients (the
    gang's averages, in ``.grad``) against the one-process gradient on all
    of ``tokens`` at its current parameters, and where.  The flash
    launches it makes are added to ``launches_taken``."""
    import torch

    from horovod_tpu_torch.ops import flash_attention as fa

    before = dict(fa.launches)
    params = dict(model.named_parameters())
    loss = tfm.loss_fn(model, tokens, targets)
    ones = torch.autograd.grad(loss, list(params.values()),
                               allow_unused=True)
    gaps = {}
    for (n, p), g in zip(params.items(), ones):
        g = torch.zeros_like(p) if g is None else g
        gaps[n] = float((p.grad.double() - g.double()).norm()
                        / g.double().norm().clamp_min(1e-30))
    for k, n in fa.launches.items():
        launches_taken[k] += n - before[k]
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def _engine_knobs(eng):
    """(fusion bytes, cycle ms to 3 places as the autotune log writes it,
    cache switch, ring segment bytes) of a running engine."""
    return [int(eng.fusion_threshold), round(eng.cycle_time * 1e3, 3),
            int(bool(eng._cache_classify_enabled)),
            int(eng.ring_segment_bytes)]


def _telemetry_readings(hvd, eng):
    """The telemetry phase, after the steps: a barrier, TEL_SETTLE_S for
    the last flushes and folds, this rank's own snapshot and the engine's
    knobs, and on rank 0 its /gang/metrics.json; a last barrier keeps both
    ranks up until rank 0 has read it."""
    import urllib.request

    hvd.barrier()
    time.sleep(TEL_SETTLE_S)
    k = _engine_knobs(eng)
    out = {"snapshot": hvd.metrics_snapshot(),
           "knobs": {"fusion_threshold": k[0], "cycle_time": eng.cycle_time,
                     "cache": k[2], "ring_segment_bytes": k[3]}}
    if hvd.rank() == 0:
        url = (f"http://127.0.0.1:{os.environ['HVD_METRICS_PORT']}"
               "/gang/metrics.json")
        with urllib.request.urlopen(url, timeout=30) as r:
            out["gang_view"] = json.loads(r.read().decode())
    hvd.barrier()
    return out


# The data-plane phase: DP_RANKS ranks of this script (``--dataplane-rank
# R``), all on one card, as two virtual nodes of two ranks
# (HVD_LOCAL_*/HVD_CROSS_*) with the hierarchical allreduce and allgather,
# the recovery ladder (HVD_WIRE_CRC=1) and the timeline on, and ranks 2-3
# under HVD_SHM_DISABLE: node 0's pair runs over shm, every other pair
# over TCP.  Each rank makes seeded card tensors at the flagship's widths
# (one block's gradient shapes and the embedding, in fp32 and in bf16,
# one int32 tensor) and runs allreduce (Sum and Average), a ragged
# allgather and broadcasts twice: clean, then under DP_PLANS.  Each rank
# rebuilds every rank's inputs from the seeds: the int32 allreduce, the
# allgather and the broadcasts are held to them bit for bit, and each fp32
# and bf16 allreduce element to the float64 sum of the inputs within
# DP_TOL times the sum of the inputs' magnitudes.  The hierarchical
# allreduce of 2 x 2 ranks rounds each element twice (once after the local
# hop, once after the cross hop; an Average's division by 4 is exact), so
# each element is within 2u of the exact sum's magnitudes, u the unit
# roundoff (2^-24 fp32, 2^-8 bf16, whose hop adds in fp32 and rounds back
# to bf16); DP_TOL is twice that.  The faulted pass must give the clean
# pass's bits on every rank: the ladder heals in place.
DP_RANKS = 4
DP_TOL = {"float32": 4 * 2.0 ** -24, "bfloat16": 4 * 2.0 ** -8}
DP_TIMEOUT_S = 300
# Pass 2's fault plans, by rank: rank 0 loses its shm ring to rank 1 once
# (the pair fails over to TCP) and corrupts two of its data writes to rank
# 2; rank 2 resets its socket to rank 0 once (rank 0 re-dials); ranks 1-3
# corrupt two writes each on a TCP link.  So rank 0 heals a link to rank
# 1 (TRANSPORT_FAILOVER, HOP_RETRY "failover") and replays to rank 2
# (HOP_RETRY "corrupt" and "reset"), all on its timeline.
DP_PLANS = {
    0: [{"site": "shm.lost", "kind": "error", "after": 10, "times": 1},
        {"site": "sock.corrupt", "kind": "corrupt", "match": "2",
         "after": 2, "times": 2}],
    1: [{"site": "sock.corrupt", "kind": "corrupt", "match": "3",
         "after": 2, "times": 2}],
    2: [{"site": "sock.reset", "kind": "error", "match": "0", "after": 3,
         "times": 1},
        {"site": "sock.corrupt", "kind": "corrupt", "match": "3",
         "after": 2, "times": 2}],
    3: [{"site": "sock.corrupt", "kind": "corrupt", "match": "2",
         "after": 2, "times": 2}],
}
DP_RANK0_HEALS = {("TRANSPORT_FAILOVER", 1, None), ("HOP_RETRY", 1, "failover"),
                  ("HOP_RETRY", 2, "corrupt"), ("HOP_RETRY", 2, "reset")}


def _dp_env(rank, tmp):
    env = dict(HVD_RANK=str(rank), HVD_SIZE=str(DP_RANKS),
               HVD_LOCAL_RANK=str(rank % 2), HVD_LOCAL_SIZE="2",
               HVD_CROSS_RANK=str(rank // 2), HVD_CROSS_SIZE="2",
               HVD_HIERARCHICAL_ALLREDUCE="1",
               HVD_HIERARCHICAL_ALLGATHER="1", HVD_WIRE_CRC="1",
               HVD_TIMELINE=os.path.join(tmp, "timeline.json"),
               HVD_TIMELINE_MARK_CYCLES="1")
    if rank >= 2:
        env["HVD_SHM_DISABLE"] = "1"
    return env


def run_dataplane(tfm, dev, card, cfg=None, timeout=DP_TIMEOUT_S):
    """The data-plane phase (see DP_RANKS): spawns the ranks, then holds
    their reports to each other (every result's digest equal on every
    rank, the faulted pass's equal to the clean pass's, the media, the
    fired faults) and rank 0's timeline to Chrome-tracing JSON with the
    negotiations, the cycle marks and the ladder's instants."""
    import tempfile

    cfg = cfg or _flagship_cfg(tfm)
    with tempfile.TemporaryDirectory() as tmp:
        fields = {f.name: getattr(cfg, f.name)
                  for f in dataclasses.fields(cfg)}
        fields["compute_dtype"] = str(cfg.compute_dtype).split(".")[1]
        with open(os.path.join(tmp, "config.json"), "w") as fh:
            json.dump({"cfg": fields, "device": str(dev)}, fh)
        t0 = time.perf_counter()
        _spawn_ranks("--dataplane-rank", DP_RANKS, tmp,
                     lambda r: _dp_env(r, tmp), timeout, "dataplane")
        wall = time.perf_counter() - t0
        ranks = []
        for r in range(DP_RANKS):
            with open(os.path.join(tmp, f"rank{r}.json")) as fh:
                ranks.append(json.load(fh))
        with open(os.path.join(tmp, "timeline.json")) as fh:
            timeline = json.load(fh)  # fails unless it is whole JSON

    failures = []
    for r, res in enumerate(ranks):
        if not res["checks_ok"]:
            failures.append(f"rank {r}: {res['bad']}")
        if res["digests"]["p1"] != ranks[0]["digests"]["p1"]:
            failures.append(f"rank {r}: the clean pass's results differ "
                            "from rank 0's")
        if res["digests"]["p2"] != res["digests"]["p1"]:
            bad = [k for k in res["digests"]["p1"]
                   if res["digests"]["p2"].get(k) != res["digests"]["p1"][k]]
            failures.append(f"rank {r}: the faulted pass's results differ "
                            f"from the clean pass's: {bad[:5]}")
        want1 = {str(p): "shm" if {r, p} == {0, 1} else "tcp"
                 for p in range(DP_RANKS) if p != r}
        want2 = {str(p): "tcp" for p in range(DP_RANKS) if p != r}
        print(f"dataplane rank {r}: link media by peer, clean pass "
              f"{res['media']['p1']}, after the faulted pass "
              f"{res['media']['p2']}; hierarchical (allreduce, allgather, "
              f"topology) {res['hierarchical']}; faults fired "
              f"{res['fired']} of {[f['times'] for f in DP_PLANS[r]]}; "
              + "; ".join(f"{k} {res['seconds'][k]:.3f} s, "
                          f"{res['bytes'] / res['seconds'][k] / 1e9:.3f} "
                          "GB/s" for k in ("p1", "p2"))
              + f" ({res['bytes']} input bytes a pass); worst |got - "
              f"exact| / (sum |x|) {res['worst']}")
        if res["media"]["p1"] != want1 or res["media"]["p2"] != want2:
            failures.append(f"rank {r}: link media {res['media']}, want "
                            f"{want1} then {want2}")
        if res["hierarchical"] != [True, True, True]:
            failures.append(f"rank {r}: the hierarchical data plane is "
                            f"off: {res['hierarchical']}")
        if res["fired"] != [f["times"] for f in DP_PLANS[r]]:
            failures.append(f"rank {r}: faults fired {res['fired']}")

    names = {e["tid"]: e["args"]["name"] for e in timeline
             if e.get("ph") == "M" and e.get("name") == "thread_name"}
    lanes = {}
    instants = []
    for e in timeline:
        if not e or e.get("ph") == "M":
            continue
        if e["tid"] == 0:
            instants.append(e)
        else:
            lanes.setdefault(names[e["tid"]], []).append(
                (e["ph"], e.get("name")))
    reduced = ranks[0]["allreduced"]
    no_negotiation = [n for n in reduced
                      if ("B", "NEGOTIATE_ALLREDUCE") not in lanes.get(n, [])]
    starts = sum(lane.count(("B", "ALLREDUCE")) for lane in lanes.values())
    stray = [n for n, lane in lanes.items()
             if ("B", "ALLREDUCE") in lane and n not in reduced]
    heals = {(e["name"], e["args"]["peer"], e["args"].get("cause"))
             for e in instants
             if e.get("name") in ("HOP_RETRY", "TRANSPORT_FAILOVER")}
    retries = {}
    for e in instants:
        if e.get("name") == "HOP_RETRY":
            key = f"peer {e['args']['peer']} {e['args']['cause']}"
            retries[key] = retries.get(key, 0) + 1
    failovers = [e["args"]["peer"] for e in instants
                 if e.get("name") == "TRANSPORT_FAILOVER"]
    cycles = sum(1 for e in instants if e.get("name") == "CYCLE_START")
    print(f"dataplane: {DP_RANKS} ranks on {dev} ({card}), {wall:.1f} s "
          f"wall; rank 0's timeline: {len(timeline)} events, {cycles} "
          f"CYCLE_START, {len(reduced)} allreduced names, "
          f"{starts} ALLREDUCE starts for {ranks[0]['allreduce_responses']} "
          f"allreduce responses; ladder instants: HOP_RETRY {retries}, "
          f"TRANSPORT_FAILOVER to peers {failovers}")
    if no_negotiation:
        failures.append(f"timeline: no NEGOTIATE_ALLREDUCE for "
                        f"{no_negotiation[:5]}")
    if starts != ranks[0]["allreduce_responses"] or stray:
        failures.append(f"timeline: {starts} ALLREDUCE starts ({stray[:5]} "
                        f"on other lanes) for "
                        f"{ranks[0]['allreduce_responses']} responses")
    if not cycles:
        failures.append("timeline: no CYCLE_START")
    if not DP_RANK0_HEALS <= heals:
        failures.append(f"timeline: ladder instants {sorted(heals, key=str)}"
                        f" lack {sorted(DP_RANK0_HEALS - heals, key=str)}")
    if failures:
        raise AssertionError("dataplane: " + "; ".join(failures))
    return ranks


def _dp_tensor(torch, dev, key, shape, dtype):
    """One seeded input: normal values (fp32 and bf16), or integers in
    [-1000, 1000) (int32), made on ``dev`` from a seed of ``key``."""
    import zlib

    gen = torch.Generator(device=dev).manual_seed(
        zlib.crc32(repr(key).encode()))
    if dtype == torch.int32:
        return torch.randint(-1000, 1000, shape, generator=gen,
                             device=dev, dtype=torch.int32)
    return torch.randn(shape, generator=gen, device=dev).to(dtype)


def dataplane_rank(rank: int, tmp: str) -> int:
    """One rank of the data-plane phase (``--dataplane-rank``); writes its
    report to ``<tmp>/rank<r>.json``."""
    import hashlib

    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import basics
    from horovod_tpu_torch.common import fault_injection as fi
    from horovod_tpu_torch.models import transformer as tfm

    with open(os.path.join(tmp, "config.json")) as fh:
        conf = json.load(fh)
    fields = dict(conf["cfg"])
    fields["compute_dtype"] = getattr(torch, fields["compute_dtype"])
    fields["n_layers"] = 1
    cfg = tfm.TransformerConfig(**fields)
    dev = torch.device(conf["device"])
    if dev.type == "cpu":
        torch.set_num_threads(1)
    # The flagship's gradient shapes: one block's and the embedding's.
    shapes = [(n, tuple(p.shape)) for n, p in
              tfm.init(0, cfg, device=dev).named_parameters()]
    d = cfg.d_model
    # One int32 tensor at the widest block matrix's shape; ragged
    # allgather blocks of (r + 1) * 256 rows of d_model.
    int_shape = max((s for _, s in shapes if len(s) == 2 and
                     s[0] != cfg.vocab_size), key=lambda s: s[0] * s[1])
    f32, bf16, i32 = torch.float32, torch.bfloat16, torch.int32
    hvd.init(device=dev, backend="none")
    size = hvd.size()
    res = {"rank": rank, "digests": {}, "media": {}, "seconds": {},
           "bad": [], "worst": {}}
    try:
        eng = basics._engine_obj
        res["hierarchical"] = [bool(eng.hierarchical_allreduce),
                               bool(eng.hierarchical_allgather),
                               bool(eng.hierarchical_topology_ok())]

        def inputs(r):
            out = {}
            for n, s in shapes:
                for dt in (f32, bf16):
                    out[(n, dt)] = _dp_tensor(torch, dev, ("g", n, dt, r),
                                              s, dt)
            out[("int", i32)] = _dp_tensor(torch, dev, ("i", r), int_shape,
                                           i32)
            for dt in (f32, bf16, i32):
                out[("ag", dt)] = _dp_tensor(torch, dev, ("ag", dt, r),
                                             ((r + 1) * 256, d), dt)
                out[("bc", dt)] = _dp_tensor(torch, dev, ("bc", dt, r),
                                             (4 * d, d), dt)
            return out

        mine = inputs(rank)
        # The bytes of this rank's inputs to one pass's collectives.
        res["bytes"] = 0

        def run_pass(tag):
            nbytes = 0
            handles = {}
            # By type and op, so that fusion can merge consecutive
            # responses.
            for dt, op in ((f32, "Sum"), (f32, "Average"), (bf16, "Sum"),
                           (bf16, "Average"), (i32, "Sum")):
                for (n, t_dt), t in mine.items():
                    if t_dt != dt or n in ("ag", "bc"):
                        continue
                    handles[(n, str(dt), op)] = hvd.allreduce_async(
                        t, name=f"{tag}.ar.{n}.{dt}.{op}",
                        op=getattr(hvd, op))
                    nbytes += t.numel() * t.element_size()
            out = {k: hvd.synchronize(h) for k, h in handles.items()}
            for dt in (f32, bf16, i32):
                out[("ag", str(dt))] = hvd.allgather(
                    mine[("ag", dt)], name=f"{tag}.ag.{dt}")
                nbytes += mine[("ag", dt)].numel() * \
                    mine[("ag", dt)].element_size()
                for root in (0, size - 1):
                    out[("bc", str(dt), root)] = hvd.broadcast(
                        mine[("bc", dt)], root_rank=root,
                        name=f"{tag}.bc.{dt}.{root}")
                    nbytes += mine[("bc", dt)].numel() * \
                        mine[("bc", dt)].element_size()
            res["bytes"] = nbytes
            return out

        def digest(t):
            return hashlib.sha256(t.detach().contiguous().cpu().reshape(-1)
                                  .view(torch.uint8).numpy()).hexdigest()

        eng.response_log = []
        _sync_dev(torch, dev)
        t0 = time.perf_counter()
        got = run_pass("p1")
        _sync_dev(torch, dev)
        res["seconds"]["p1"] = time.perf_counter() - t0
        res["allreduced"] = [f"{tag}.ar.{k[0]}.{k[1]}.{k[2]}" for k in got
                             if k[0] != "bc" and len(k) == 3
                             for tag in ("p1", "p2")]
        res["media"]["p1"] = {str(p): m for p, m in
                              eng.transport_media().items()}
        res["digests"]["p1"] = {repr(k): digest(v) for k, v in got.items()}

        # Every rank's inputs, rebuilt from the seeds, for the checks.
        others = [mine if r == rank else inputs(r) for r in range(size)]
        for (n, dt), t in mine.items():
            if n in ("ag", "bc"):
                continue
            if dt == i32:
                want = sum(o[(n, dt)].long() for o in others).to(i32)
                if not torch.equal(got[(n, str(dt), "Sum")], want):
                    res["bad"].append(f"int32 allreduce {n}")
                continue
            exact = sum(o[(n, dt)].double() for o in others)
            mag = sum(o[(n, dt)].double().abs() for o in others)
            tol = DP_TOL[str(dt).split(".")[1]]
            for op, div in (("Sum", 1), ("Average", size)):
                g = got[(n, str(dt), op)]
                if g.dtype != dt or g.device != t.device:
                    res["bad"].append(f"{n} {dt} {op}: {g.dtype} on "
                                      f"{g.device}")
                    continue
                err = ((g.double() - exact / div).abs()
                       / (mag / div).clamp_min(1e-300))
                worst = float(err.max())
                key = f"{str(dt).split('.')[1]} {op}"
                res["worst"][key] = max(res["worst"].get(key, 0.0), worst)
                if not worst <= tol:
                    res["bad"].append(f"{n} {dt} {op}: {worst:.3e} of "
                                      f"sum |x| > {tol:.3e}")
        for dt in (f32, bf16, i32):
            want = torch.cat([o[("ag", dt)] for o in others])
            if not torch.equal(got[("ag", str(dt))], want):
                res["bad"].append(f"allgather {dt}")
            for root in (0, size - 1):
                if not torch.equal(got[("bc", str(dt), root)],
                                   others[root][("bc", dt)]):
                    res["bad"].append(f"broadcast {dt} from {root}")
        del others, got

        fi.configure({"seed": rank, "faults": DP_PLANS[rank]})
        _sync_dev(torch, dev)
        t0 = time.perf_counter()
        got = run_pass("p2")
        _sync_dev(torch, dev)
        res["seconds"]["p2"] = time.perf_counter() - t0
        res["fired"] = [f.fired for f in fi._PLAN.faults]
        fi.clear()
        # Both passes' responses: one ALLREDUCE start on the timeline each.
        res["allreduce_responses"] = sum(
            1 for e in eng.response_log if e[0] == "ALLREDUCE")
        eng.response_log = None
        res["media"]["p2"] = {str(p): m for p, m in
                              eng.transport_media().items()}
        res["digests"]["p2"] = {repr(k): digest(v) for k, v in got.items()}
        res["checks_ok"] = not res["bad"]
    finally:
        fi.clear()
        hvd.shutdown()
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as fh:
        json.dump(res, fh)
    return 0


# The liveness phase: the flagship's gradient gang through the engine with
# its self-healing knobs on, killed and stalled.  Gang A: LV_A_RANKS ranks
# of this script (``--liveness-rank R``) on the card as two virtual nodes
# of two (node 0's pair on shm, every other pair on TCP, as the data-plane
# phase), with heartbeats (2.0 s, every 0.25 s), a 10 s collective
# deadline and the control tree (the default: rank 2 folds rank 3's
# control frames).  Rank 2 is killed at ``train.step`` after step 1, once
# the survivors have submitted step 2 (each writes a marker file when it
# has): rank 3 re-parents to the root, the in-flight step 2 completes over
# {0, 1, 3} and step 3's submission raises RanksFailedError([2]).  Gang B:
# LV_B_RANKS ranks on one node over the shm ring with the 10 s deadline;
# rank 2 stalls its next shm receive at step 1, and both survivors raise
# CollectiveTimeoutError([2]) within twice the deadline of the step's
# submission.  Both gangs run the flagship at its full width and
# LV_LAYERS layers, each rank on LV_ROWS rows of batches from seed 7, no
# optimizer (every step's gradients at the initial weights), one
# allreduce_async(Average) per gradient.  ENGINE_GRAD_TOL holds the step-0
# average against the one-process gradient on all the rows, and the
# step-2 average against the mean of the three survivors' gradients
# recomputed here (the engine's arithmetic over the survivor group: the
# average divides by three).
LV_LAYERS = 2
LV_ROWS = 2
LV_A_RANKS = 4
LV_A_STEPS = 4
LV_A_VICTIM = 2
LV_B_RANKS = 3
LV_B_STEPS = 2
LV_B_VICTIM = 2
LV_DEADLINE_S = 10.0
LV_KNOBS = {"HVD_HEARTBEAT_TIMEOUT": "2.0", "HVD_HEARTBEAT_INTERVAL": "0.25",
            "HVD_COLLECTIVE_TIMEOUT": str(LV_DEADLINE_S)}
LV_TIMEOUT_S = 240


def _lv_env(gang, rank, tmp):
    # The flight recorder's dumps and each rank's metrics (the registry on
    # through its JSONL flusher) under the phase's directory.
    env = dict(LV_KNOBS, HVD_RANK=str(rank),
               HVD_BLACKBOX_DIR=os.path.join(tmp, f"blackbox{gang}"),
               HVD_METRICS_FILE=os.path.join(tmp,
                                             f"metrics{gang}{rank}.jsonl"))
    if gang == "A":
        env.update(HVD_SIZE=str(LV_A_RANKS), HVD_LOCAL_RANK=str(rank % 2),
                   HVD_LOCAL_SIZE="2", HVD_CROSS_RANK=str(rank // 2),
                   HVD_CROSS_SIZE="2")
        if rank >= 2:
            env["HVD_SHM_DISABLE"] = "1"
        if rank == LV_A_VICTIM:
            env["HOROVOD_FAULT_PLAN"] = json.dumps({"faults": [
                {"site": "train.step", "kind": "kill", "after": 2}]})
    else:
        env.update(HVD_SIZE=str(LV_B_RANKS), HVD_LOCAL_RANK=str(rank),
                   HVD_LOCAL_SIZE=str(LV_B_RANKS))
    if rank == 0:
        env["HVD_TIMELINE"] = os.path.join(tmp, f"timeline{gang}.json")
    return env


def _lv_grads(tfm, model, tokens, targets, rows):
    """The flagship's gradients on ``rows`` of a batch, by name."""
    model.zero_grad(set_to_none=True)
    tfm.loss_fn(model, tokens[rows], targets[rows]).backward()
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()}


def _lv_gap(got, want):
    """The largest |got - want| / |want| over the parameters, and where."""
    gaps = {n: float((got[n].to(w.device).double() - w.double()).norm()
                     / w.double().norm().clamp_min(1e-30))
            for n, w in want.items()}
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def run_liveness(tfm, dev, card, cfg=None, timeout=LV_TIMEOUT_S):
    """The liveness phase (see LV_LAYERS): gang A, gang B, then checks of
    their reports, rank 0's timelines, the survivors' gradients against
    this process's, the port's postmortem tool over each gang's
    flight-recorder dumps (its first cause must be the killed or the
    stalled rank) and the leftover shm segments."""
    import glob
    import tempfile

    import torch

    from horovod_tpu_torch.tools import hvd_postmortem

    t_phase = time.perf_counter()
    cfg = cfg or _flagship_cfg(tfm)
    cfg = dataclasses.replace(cfg, n_layers=LV_LAYERS)
    failures = []
    rep = {}
    with tempfile.TemporaryDirectory() as tmp:
        fields = {f.name: getattr(cfg, f.name)
                  for f in dataclasses.fields(cfg)}
        fields["compute_dtype"] = str(cfg.compute_dtype).split(".")[1]
        pids = {}
        for gang, n, steps, expect, stalled in (
                ("A", LV_A_RANKS, LV_A_STEPS, {LV_A_VICTIM: 137}, ()),
                ("B", LV_B_RANKS, LV_B_STEPS, None, (LV_B_VICTIM,))):
            with open(os.path.join(tmp, "config.json"), "w") as fh:
                json.dump({"cfg": fields, "device": str(dev), "gang": gang,
                           "steps": steps}, fh)
            t0 = time.perf_counter()
            pids[gang] = []
            _spawn_ranks("--liveness-rank", n, tmp,
                         lambda r, g=gang: _lv_env(g, r, tmp), timeout,
                         f"liveness {gang}", expect=expect, stalled=stalled,
                         pids=pids[gang])
            rep[gang] = {"wall": time.perf_counter() - t0}
            for r in range(n):
                path = os.path.join(tmp, f"{gang}{r}.json")
                if os.path.exists(path):
                    with open(path) as fh:
                        rep[gang][r] = json.load(fh)
            with open(os.path.join(tmp, f"timeline{gang}.json")) as fh:
                rep[gang]["timeline"] = fh.read()
            if gang == "A":
                got = torch.load(os.path.join(tmp, "A0.pt"))
            else:
                rep[gang]["stall_at"] = float(open(os.path.join(
                    tmp, "B_stall_at")).read())
            rep[gang]["dumps"] = _lv_dumps(os.path.join(tmp,
                                                        f"blackbox{gang}"))
            rep[gang]["postmortem"] = hvd_postmortem.analyze(
                os.path.join(tmp, f"blackbox{gang}"))
            if gang == "A":
                # The root's last flush (at its shutdown; gang B's
                # survivors stop with os._exit, before any).
                with open(os.path.join(tmp, "metricsA0.jsonl")) as fh:
                    rep[gang]["root_metrics"] = json.loads(
                        fh.read().splitlines()[-1])
        rep["A"]["kill_at"] = float(open(os.path.join(
            tmp, "A_kill_at")).read())
        leftover = [f for g in pids.values() for pid in g
                    for f in glob.glob(f"/dev/shm/hvd-shm-{pid}-*")]

    a, b = rep["A"], rep["B"]
    survivors = [r for r in range(LV_A_RANKS) if r != LV_A_VICTIM]
    # Gang A: digests, markers, the tree, the timeline.
    for s in (0, 1):
        if len({a[r]["digests"][s] for r in range(LV_A_RANKS)}) != 1:
            failures.append(f"A: step {s}'s averages differ across ranks")
    if len({a[r]["digests"][2] for r in survivors}) != 1:
        failures.append("A: step 2's averages differ across the survivors")
    for r in survivors:
        if a[r]["failed"] != [[LV_A_VICTIM], 3]:
            failures.append(f"A rank {r}: RanksFailedError "
                            f"{a[r]['failed']}, want [[2], 3]")
    for gang, r in [("A", r) for r in survivors] + [("B", 0), ("B", 1)]:
        launches = rep[gang][r]["launches"]
        if dev.type == "cuda" and not all(launches[k] > 0
                                          for k in ("fwd", "dq", "dkv")):
            failures.append(f"{gang} rank {r}: flash launches {launches}")
    if a[3]["tree"] != [LV_A_VICTIM, True] or a[0]["reparented"] != [3]:
        failures.append(f"A: rank 3's tree {a[3]['tree']}, the root's "
                        f"adopted {a[0]['reparented']}")
    if "SUBCOORD_REPARENT" not in a["timeline"]:
        failures.append("A: no SUBCOORD_REPARENT on rank 0's timeline")
    if "COLLECTIVE_ABORT" in a["timeline"]:
        failures.append("A: a COLLECTIVE_ABORT on rank 0's timeline")
    # Gang A's flight recorder: each survivor's dump, the root's counters.
    evictions = a["root_metrics"]["counters"].get("hvd_evictions_total")
    for r in survivors:
        doc = a["dumps"].get(f"blackbox_rank{r}.json")
        if not doc or doc["schema"] != "hvd-blackbox-v1" or \
                doc["reason"] != "ranks_failed":
            failures.append(f"A rank {r}: dump {doc and doc['reason']}")
    if evictions != 1:
        failures.append(f"A: the root's hvd_evictions_total {evictions}")
    print(f"liveness A: dumps {sorted(a['dumps'])} (reasons "
          f"{[d['reason'] for _, d in sorted(a['dumps'].items())]}, "
          f"{[len(d['events']) for _, d in sorted(a['dumps'].items())]} "
          f"events), the root's hvd_evictions_total {evictions}, "
          f"hvd_heartbeat_misses_total "
          f"{a['root_metrics']['counters'].get('hvd_heartbeat_misses_total')}"
          f", hvd_subcoord_reparents_total "
          f"{a['root_metrics']['counters'].get('hvd_subcoord_reparents_total')}")
    # Gang A's gradients against this process's.
    model = tfm.init(0, cfg, device=dev)
    batches = _token_batches(dev, LV_A_STEPS, B=LV_A_RANKS * LV_ROWS,
                             S=cfg.max_seq_len, vocab=cfg.vocab_size,
                             seed=7)
    want0 = _lv_grads(tfm, model, *batches[0],
                      slice(0, LV_A_RANKS * LV_ROWS))
    gap0 = _lv_gap(got["grads0"], want0)
    del want0
    want2 = None
    for r in survivors:
        g = _lv_grads(tfm, model, *batches[2],
                      slice(r * LV_ROWS, (r + 1) * LV_ROWS))
        want2 = {n: x.double() for n, x in g.items()} if want2 is None \
            else {n: want2[n] + g[n].double() for n in want2}
    want2 = {n: x / len(survivors) for n, x in want2.items()}
    gap2 = _lv_gap(got["grads2"], want2)
    del model, want2, got
    if not gap0[0] <= ENGINE_GRAD_TOL:
        failures.append(f"A: step-0 average {gap0} from the one-process "
                        "gradient")
    if not gap2[0] <= ENGINE_GRAD_TOL:
        failures.append(f"A: step-2 average {gap2} from the survivors' mean")
    evict_s = a[0]["evict_at"] - a["kill_at"]
    first = [a[r]["step_ms"][0] for r in range(LV_A_RANKS)]
    full = [a[r]["step_ms"][1] for r in range(LV_A_RANKS)]
    print(f"liveness A: {LV_A_RANKS} ranks, d_model {cfg.d_model}, "
          f"{cfg.n_layers} layers, on {card}; {a['wall']:.1f} s wall; step "
          f"ms of the full gang: step 0 (the ranks' first) "
          f"{[round(x, 1) for x in first]}, step 1 "
          f"{[round(x, 1) for x in full]}, median "
          f"{statistics.median(full):.1f}; step 2 over {survivors} ms "
          f"{[round(a[r]['step_ms'][2], 1) for r in survivors]}; kill to "
          f"eviction {evict_s:.3f} s; media {a[0]['media']} / "
          f"{a[3]['media']}; rank 3's parent {a[3]['tree'][0]}, orphaned "
          f"{a[3]['tree'][1]}; the root adopted {a[0]['reparented']}; "
          f"RanksFailedError {a[0]['failed'][0]} at step "
          f"{a[0]['failed'][1]}; step-0 gap {gap0[0]:.3e} ({gap0[1]}), "
          f"step-2 gap {gap2[0]:.3e} ({gap2[1]}), tol {ENGINE_GRAD_TOL}; "
          f"flash launches a rank {a[0]['launches']}")
    # Gang B.
    errs = []
    for r in range(LV_B_RANKS):
        if r == LV_B_VICTIM:
            continue
        res = b[r]
        errs.append(res["cte_at"])
        if res["cte"] is None or res["cte"][0] != [LV_B_VICTIM]:
            failures.append(f"B rank {r}: CollectiveTimeoutError "
                            f"{res['cte']}")
        elif not res["cte"][2] < 2 * LV_DEADLINE_S:
            failures.append(f"B rank {r}: the error {res['cte'][2]:.3f} s "
                            f"after the submission, past 2 x the deadline")
        if not (res["retained"] and res["retained_ok"]):
            failures.append(f"B rank {r}: retained batch of "
                            f"{res['retained']}, bits equal "
                            f"{res['retained_ok']}")
        if res["media"] != {str(p): "shm" for p in range(LV_B_RANKS)
                            if p != r}:
            failures.append(f"B rank {r}: media {res['media']}")
    if "COLLECTIVE_ABORT" not in b["timeline"]:
        failures.append("B: no COLLECTIVE_ABORT on rank 0's timeline")
    # Gang B's flight recorder: the survivors' dumps, the stalled rank's
    # ring pulled by the coordinator, the verdict naming it.
    for r in range(LV_B_RANKS):
        if r == LV_B_VICTIM:
            continue
        doc = b["dumps"].get(f"blackbox_rank{r}.json")
        if not doc or doc["reason"] != "collective_timeout":
            failures.append(f"B rank {r}: dump {doc and doc['reason']}")
    pulled = b["dumps"].get(f"blackbox_rank{LV_B_VICTIM}.pulled.json")
    if not pulled or pulled["reason"] != "coordinator_pull" or \
            not (pulled.get("in_flight") or {}).get("name"):
        failures.append(f"B: the coordinator's pull of rank "
                        f"{LV_B_VICTIM}: {pulled and pulled['reason']}")
    verdicts = [e.get("ranks") for e in
                b["dumps"].get("blackbox_rank0.json", {}).get("events", [])
                if e["kind"] == "abort.verdict"]
    if verdicts != [[LV_B_VICTIM]]:
        failures.append(f"B: the root's verdict notes {verdicts}")
    print(f"liveness B: dumps {sorted(b['dumps'])}, the root's verdict "
          f"notes {verdicts}, the pulled ring's in-flight collective "
          f"{pulled and pulled.get('in_flight')}, its events "
          f"{pulled and len(pulled['events'])}")
    for gang, victim in (("A", LV_A_VICTIM), ("B", LV_B_VICTIM)):
        v = rep[gang]["postmortem"]
        print(f"liveness {gang}: hvd_postmortem (the port's tool) over the "
              f"dumps: first cause rank {v and v['first_cause']} (the "
              f"{'killed' if gang == 'A' else 'stalled'} rank is {victim}),"
              f" the gang's ruling {v and v['gang_ruled']}, doing "
              f"{v and v['doing']}")
        if not v or v["first_cause"] != victim:
            failures.append(f"{gang}: the port's postmortem names rank "
                            f"{v and v['first_cause']}, not {victim}")
    if leftover:
        failures.append(f"shm segments left: {leftover}")
    stall_s = max(errs) - b["stall_at"] if errs else float("nan")
    print(f"liveness B: {LV_B_RANKS} ranks on shm, d_model {cfg.d_model}, "
          f"{cfg.n_layers} layers, on {card}; {b['wall']:.1f} s wall; step "
          f"0 ms "
          f"{[round(b[r]['step_ms'][0], 1) for r in range(LV_B_RANKS)]}; "
          f"CollectiveTimeoutError {b[0]['cte'][0] if b[0]['cte'] else None}"
          f" on {b[0]['cte'][1] if b[0]['cte'] else None}, "
          f"{[b[r]['cte'][2] if b[r]['cte'] else None for r in (0, 1)]} s "
          f"after the step's submission (deadline {LV_DEADLINE_S} s); the "
          f"victim's stall to the last survivor's error {stall_s:.3f} s; "
          f"retained {[b[r]['retained'] for r in (0, 1)]} tensors, bits "
          f"equal {[b[r]['retained_ok'] for r in (0, 1)]}; no shm segment "
          f"left: {not leftover}; flash launches a survivor "
          f"{b[0]['launches']}")
    if failures:
        raise AssertionError("liveness: " + "; ".join(failures))
    print(f"liveness: phase wall {time.perf_counter() - t_phase:.1f} s on "
          f"{card}")
    return rep


def _lv_dumps(d):
    """The recorder's dumps in ``d`` by file name."""
    out = {}
    for name in sorted(os.listdir(d)) if os.path.isdir(d) else ():
        with open(os.path.join(d, name)) as fh:
            out[name] = json.load(fh)
    return out


def liveness_rank(rank: int, tmp: str) -> int:
    """One rank of the liveness phase (``--liveness-rank``); writes its
    report to ``<tmp>/<gang><r>.json`` (gang A's rank 0 also its step-0
    and step-2 averages to ``A0.pt``)."""
    import hashlib
    import threading

    import numpy as np
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import basics
    from horovod_tpu_torch.common import fault_injection as fi
    from horovod_tpu_torch.models import transformer as tfm
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.runtime_py import take_retained_batch

    with open(os.path.join(tmp, "config.json")) as fh:
        conf = json.load(fh)
    fields = dict(conf["cfg"])
    fields["compute_dtype"] = getattr(torch, fields["compute_dtype"])
    cfg = tfm.TransformerConfig(**fields)
    dev = torch.device(conf["device"])
    gang = conf["gang"]
    torch.backends.cuda.matmul.allow_tf32 = False
    if dev.type == "cpu":
        torch.set_num_threads(1)
    hvd.init(device=dev, backend="none")
    size = hvd.size()
    res = {"rank": rank, "digests": [], "step_ms": [], "failed": None,
           "cte": None}
    saved = {}
    try:
        eng = basics._engine_obj
        res["media"] = {str(p): m for p, m in
                        eng.transport_media().items()}
        if rank == 0:
            # When the root first counts a rank out (gang A's eviction).
            res["evict_at"] = None

            def watch():
                while res["evict_at"] is None and not eng._closed:
                    if eng._evicted_ranks:
                        res["evict_at"] = time.time()
                    time.sleep(0.002)

            threading.Thread(target=watch, daemon=True).start()
        model = tfm.init(0, cfg, device=dev)
        rows = slice(rank * LV_ROWS, (rank + 1) * LV_ROWS)
        batches = _token_batches(dev, conf["steps"], B=size * LV_ROWS,
                                 S=cfg.max_seq_len, vocab=cfg.vocab_size,
                                 seed=7)
        stalls = gang == "B" and rank == LV_B_VICTIM
        dies = gang == "A" and rank == LV_A_VICTIM
        report = os.path.join(tmp, f"{gang}{rank}.json")

        def write_report():
            res["launches"] = dict(fa.launches)
            res["tree"] = [eng._tree_parent, eng._tree_orphaned]
            res["reparented"] = sorted(eng._reparented_ranks)
            with open(report, "w") as fh:
                json.dump(res, fh)

        fa.reset_launch_counts()
        for s, (tokens, targets) in enumerate(batches):
            _sync_dev(torch, dev)
            t0 = time.perf_counter()
            grads = _lv_grads(tfm, model, tokens, targets, rows)
            if dies and s == 2:
                # Die once every survivor has submitted step 2, and its
                # frames have had a second to reach the root.
                want = [os.path.join(tmp, f"A_sub2_{r}")
                        for r in range(size) if r != rank]
                t_wait = time.monotonic() + 60
                while not all(map(os.path.exists, want)) and \
                        time.monotonic() < t_wait:
                    time.sleep(0.01)
                time.sleep(1.0)
                with open(os.path.join(tmp, "A_kill_at"), "w") as fh:
                    fh.write(repr(time.time()))
            fi.fire("train.step", str(s))
            host = {n: g.cpu() for n, g in grads.items()} \
                if gang == "B" and s == 1 else {}
            if stalls and s == 1:
                with open(os.path.join(tmp, "B_stall_at"), "w") as fh:
                    fh.write(repr(time.time()))
                fi.configure({"faults": [{"site": "shm.stall",
                                          "kind": "stall",
                                          "stall_s": 600}]})
            t_sub = time.monotonic()
            try:
                handles = [hvd.allreduce_async(g, name=f"{n}.s{s}",
                                               op=hvd.Average)
                           for n, g in grads.items()]
                with open(os.path.join(tmp, f"{gang}_sub{s}_{rank}"),
                          "w"):
                    pass
                avg = {n: hvd.synchronize(h)
                       for n, h in zip(grads, handles)}
            except hvd.CollectiveTimeoutError as e:
                res["cte_at"] = time.time()
                res["cte"] = [e.ranks, e.tensor_name,
                              time.monotonic() - t_sub]
                batch = take_retained_batch() or []
                want = {f"{n}.s{s}": x.numpy().tobytes()
                        for n, x in host.items()}
                res["retained"] = len(batch)
                res["retained_ok"] = all(
                    want.get(it["name"]) == np.asarray(
                        it["array"]).tobytes() for it in batch)
                write_report()
                # The links may still hold the aborted collective's frames
                # (elastic would re-form the gang): stop here, after
                # closing rank 0's timeline.
                eng.timeline.shutdown()
                os._exit(0)
            except hvd.RanksFailedError as e:
                res["failed"] = [e.ranks, s]
                break
            _sync_dev(torch, dev)
            res["step_ms"].append((time.perf_counter() - t0) * 1e3)
            h = hashlib.sha256()
            for n in grads:
                h.update(avg[n].cpu().numpy().tobytes())
            res["digests"].append(h.hexdigest())
            if gang == "A" and rank == 0 and s in (0, 2):
                saved[f"grads{s}"] = {n: x.cpu() for n, x in avg.items()}
            write_report()
        if saved:
            torch.save(saved, os.path.join(tmp, "A0.pt"))
        write_report()
    finally:
        fi.clear()
        hvd.shutdown()
    return 0


# The elastic phase: the flagship's gradient gang under @hvd.elastic.run,
# shrunk, stalled and grown on the card.  Each gang runs ranks of this
# script (``--elastic-rank R``) on the card with ``hvd.init(device=dev,
# backend="none")`` and ``TorchState(model, optimizer, step=0)``: the
# flagship from seed 0's weights, AdamW(1e-3, wd 0.01), one
# allreduce_async(Average) per gradient, EL_STEPS steps.  Each step's global
# batch is EL_ROWS rows of batches from seed 7; a reset callback
# re-partitions them over the gang (2 rows a rank at size 3, 3 at size 2),
# so that the one-process trajectory on all the rows is the reference at
# any size, and a failure must give a run without one's parameters.  Each
# step's averaged gradients are held to ENGINE_GRAD_TOL against the
# one-process gradient at the ranks' own parameters (on rank 0, before its
# update), the final parameters to EL_PARAM_TOL against the one-process
# trajectory.  The gangs (heartbeats 2.0 s every 0.25 s, a membership
# check every 0.05 s):
#
# * E1, at full depth: three ranks on TCP, a commit every 2 steps; rank 0,
#   the hub, is killed at ``train.step`` after step 2, the first uncommitted
#   one.  The survivors re-form at epoch 1 as two ranks (old rank 1 leads),
#   roll back to the commit (the model and optimizer digests equal the
#   commit's), re-sync from the new rank 0 and finish.
# * E2, at LV_LAYERS layers: three ranks on the shm ring with the 10 s
#   deadline, a commit every step; rank 2 stalls its shm receive at step 1.
#   Both survivors raise CollectiveTimeoutError([2]), re-form as two ranks
#   and replay the retained batch: each gradient's replay must equal, bit
#   for bit, the survivors' retained inputs summed and halved as the engine
#   averages two ranks.  No hvd-shm segment of the gang's pids is left.
# * E3, at LV_LAYERS layers: two ranks on TCP, a commit every step; a third
#   process starts with HVD_ELASTIC_JOINER=1 once rank 0 has finished step
#   1, and the two wait at step 2 until it has announced itself, so that
#   all three interrupt at the next commit and re-form at size 3; the
#   joiner's synced state must equal rank 0's, by digest.
#
# ENGINE_GRAD_TOL holds the steps at size 2, whose ranks' token counts
# are the one process's over a power of two, as the engine phase's: the
# bf16 roundings of the loss's 1/tokens scale then agree.  At size 3 (two
# rows a rank against six) they do not, and the bf16 backward differs by
# more: on the CPU at d_model 256 the gap read 8.9e-3 at size 3 against
# 2.4e-3 at size 2 (1.0e-6 and 9.8e-8 in fp32).  So size 3 gets its own
# bound, about twice the largest card reading, 1.920e-2 (E3's last step;
# E2's size-3 step read 1.051e-2; size 2 read 2.350e-3-2.378e-3).  The
# parameters after six steps, each gang its own trajectory, read 6.774e-2
# (E1: its first two steps at size 3, which AdamW's first, sign-like
# updates carry furthest), 1.242e-2 (E2: one) and 4.667e-3 (E3: four,
# after two at size 2); each gang's bound is about twice its reading.  All
# on an NVIDIA H100 80GB HBM3 at 700.00 W.
EL_ROWS = 6
EL_STEPS = 6
EL_GRAD_TOL_3 = 4e-2
EL_PARAM_TOL = {"E1": 0.14, "E2": 2.5e-2, "E3": 1e-2}
EL_KNOBS = {"HVD_HEARTBEAT_TIMEOUT": "2.0", "HVD_HEARTBEAT_INTERVAL": "0.25",
            "HVD_ELASTIC_CHECK_INTERVAL_S": "0.05", "HVD_ELASTIC_EPOCH": "0"}
EL_GANGS = {  # ranks, commit every, depth (None: the flagship's), shm
    "E1": (3, 2, None, False),
    "E2": (3, 1, LV_LAYERS, True),
    "E3": (3, 1, LV_LAYERS, False),
}
EL_E1_VICTIM = 0
EL_E2_VICTIM = 2
EL_E3_JOINER = 2
EL_TIMEOUT_S = 300


def _el_env(gang, rank, tmp):
    n, _, _, shm = EL_GANGS[gang]
    env = dict(EL_KNOBS, HVD_RANK=str(rank), HVD_SIZE=str(n),
               HVD_LOCAL_RANK=str(rank), HVD_LOCAL_SIZE=str(n),
               HVD_ELASTIC_UID=f"uid-{rank}", HVD_ELASTIC_MIN_NP="2",
               HVD_ELASTIC_MAX_NP="3",
               HVD_BLACKBOX_DIR=os.path.join(tmp, f"blackbox{gang}"),
               HVD_TIMELINE=os.path.join(tmp, f"timeline{gang}.json"))
    if not shm:
        env["HVD_SHM_DISABLE"] = "1"
    if gang == "E1" and rank == EL_E1_VICTIM:
        env["HOROVOD_FAULT_PLAN"] = json.dumps({"faults": [
            {"site": "train.step", "kind": "kill", "after": 2}]})
    if gang == "E2":
        env["HVD_COLLECTIVE_TIMEOUT"] = str(LV_DEADLINE_S)
    if gang == "E3":
        if rank == EL_E3_JOINER:
            env["HVD_ELASTIC_JOINER"] = "1"
        else:
            env["HVD_SIZE"] = "2"
    return env


def _el_tensors(model, opt):
    """The model's and the optimizer's state tensors, in a fixed order."""
    import torch

    out = [t for _, t in sorted(model.state_dict().items())]
    for _, st in sorted(opt.state_dict()["state"].items()):
        out += [st[k] for k in sorted(st) if isinstance(st[k], torch.Tensor)]
    return out


def _el_digest(model, opt):
    """A digest of the model's and the optimizer's state, bit by bit: a
    position-weighted checksum of each tensor's bits (as int32, int16 or
    bytes), taken on its device in chunks, folded by sha256."""
    import hashlib

    import torch

    h = hashlib.sha256()
    for t in _el_tensors(model, opt):
        x = t.detach().contiguous().reshape(-1)
        x = x.view({4: torch.int32, 2: torch.int16}.get(x.element_size(),
                                                         torch.uint8))
        for i in range(0, x.numel(), 1 << 24):
            y = x[i:i + (1 << 24)].to(torch.int64)
            w = torch.arange(i + 1, i + 1 + y.numel(), device=y.device,
                             dtype=torch.int64) % 1000003
            h.update(repr((int((y * w).sum()), int(y.sum()),
                           y.numel())).encode())
    return h.hexdigest()[:16]


def _el_ref(tfm, cfg, dev, steps):
    """The one-process trajectory on all EL_ROWS rows: the parameters
    after ``steps`` steps from seed 0's weights."""
    import horovod_tpu_torch as hvd

    batches = _token_batches(dev, steps, B=EL_ROWS, S=cfg.max_seq_len,
                             vocab=cfg.vocab_size, seed=7)
    with _INPROC:
        hvd.init(device=dev)
        try:
            step_fn, init_fn = hvd.make_transformer_train_step(cfg,
                                                               device=dev)
            state = init_fn(0)
            for tokens, targets in batches:
                state, _ = step_fn(state, tokens, targets)
            return {n: p.detach().clone()
                    for n, p in state.model.named_parameters()}
        finally:
            hvd.shutdown()


def _el_span(rep, t_fail):
    """The re-form's parts on one survivor, in seconds: failure (the kill,
    stall or announcement) to the error in the training function, to the
    reset callback (the re-form: teardown, the world, init), the sync, to
    the function's re-entry (the replay), to the first step's end."""
    first = next(s for s in rep["steps"] if s["epoch"] == 1)
    sync = rep["syncs"][-1]
    entry = rep["entries"][-1]["t"]
    return dict(detect=rep["detect"] - t_fail,
                reform=rep["resets"][-1]["t"] - rep["detect"],
                sync=sync["t1"] - sync["t0"], sync_bytes=sync["bytes"],
                sync_gbs=sync["bytes"] / max(sync["t1"] - sync["t0"], 1e-9)
                / 1e9,
                replay=entry - sync["t1"], first_step=first["t1"] - entry,
                total=first["t1"] - t_fail)


def _el_medians(rep):
    """The step medians (ms) before and after the re-form, the process's
    first step (its warm-up) left out."""
    out = []
    for epoch in (0, 1):
        ms = [s["ms"] for s in rep["steps"][1:] if s["epoch"] == epoch]
        out.append(round(statistics.median(ms), 1) if ms else None)
    return out


def run_elastic(tfm, fa, dev, card, cfg=None, timeout=EL_TIMEOUT_S):
    """The elastic phase (see EL_ROWS): E1, E2 and E3, then their checks
    against this process's trajectories and recomputed gradients."""
    import glob
    import tempfile

    import torch

    t_phase = time.perf_counter()
    full = cfg or _flagship_cfg(tfm)
    failures = []
    rep = {}
    with tempfile.TemporaryDirectory() as tmp:
        pids = {}
        for gang, (n, commit, depth, _) in EL_GANGS.items():
            gcfg = full if depth is None else dataclasses.replace(
                full, n_layers=depth)
            fields = {f.name: getattr(gcfg, f.name)
                      for f in dataclasses.fields(gcfg)}
            fields["compute_dtype"] = str(gcfg.compute_dtype).split(".")[1]
            with open(os.path.join(tmp, "config.json"), "w") as fh:
                json.dump({"cfg": fields, "device": str(dev), "gang": gang,
                           "commit": commit}, fh)
            t0 = time.perf_counter()
            pids[gang] = []
            _spawn_ranks(
                "--elastic-rank", n, tmp,
                lambda r, g=gang: _el_env(g, r, tmp), timeout,
                f"elastic {gang}",
                expect={EL_E1_VICTIM: 137} if gang == "E1" else None,
                stalled=(EL_E2_VICTIM,) if gang == "E2" else (),
                late={EL_E3_JOINER: os.path.join(tmp, "E3_step1")}
                if gang == "E3" else None,
                pids=pids[gang])
            rep[gang] = {"wall": time.perf_counter() - t0, "cfg": gcfg}
            for r in range(n):
                path = os.path.join(tmp, f"{gang}{r}.json")
                if os.path.exists(path):
                    with open(path) as fh:
                        rep[gang][r] = json.load(fh)
            with open(os.path.join(tmp, f"timeline{gang}.json")) as fh:
                rep[gang]["timeline"] = fh.read()
            rep[gang]["final"] = torch.load(
                os.path.join(tmp, f"{gang}_final.pt"))
            for name in ("kill_at", "stall_at"):
                path = os.path.join(tmp, f"{gang}_{name}")
                if os.path.exists(path):
                    with open(path) as fh:
                        rep[gang][name] = float(fh.read())
            if gang == "E2":
                rep[gang]["inputs"] = {r: torch.load(os.path.join(
                    tmp, f"E2_in{r}.pt")) for r in (0, 1)}
                rep[gang]["replay"] = torch.load(os.path.join(
                    tmp, "E2_replay.pt"))
                rep[gang]["p1"] = torch.load(os.path.join(tmp, "E2_p1.pt"))
        leftover = [f for pid in pids["E2"]
                    for f in glob.glob(f"/dev/shm/hvd-shm-{pid}-*")]

    refs = {}
    for gang in EL_GANGS:
        g = rep[gang]
        depth = g["cfg"].n_layers
        if depth not in refs:
            refs[depth] = _el_ref(tfm, g["cfg"], dev, EL_STEPS)
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        survivors = [r for r in range(EL_GANGS[gang][0])
                     if not (gang == "E1" and r == EL_E1_VICTIM)
                     and not (gang == "E2" and r == EL_E2_VICTIM)]
        gap = _lv_gap(g["final"], refs[depth])
        finals = {g[r]["final_digest"] for r in survivors}
        print(f"elastic {gang}: {len(survivors)} ranks finished, d_model "
              f"{g['cfg'].d_model}, {depth} layers, on {card}; "
              f"{g['wall']:.1f} s wall; final digests {sorted(finals)}; "
              f"largest |p - p_one| / |p_one| after {EL_STEPS} steps "
              f"{gap[0]:.3e} ({gap[1]}; tol {EL_PARAM_TOL[gang]})")
        if len(finals) != 1:
            failures.append(f"{gang}: the survivors' parameters differ")
        if not gap[0] <= EL_PARAM_TOL[gang]:
            failures.append(f"{gang}: the parameters {gap} from the "
                            "one-process trajectory")
        for r in survivors:
            res = g[r]
            if res["grad_gaps"]:
                rows = [(x[0], x[1], x[2], f"{x[3]:.3e}")
                        for x in res["grad_gaps"]]
                print(f"elastic {gang} rank {r}: each step's averaged "
                      f"gradients against the one-process gradient (step, "
                      f"epoch, size, gap) {rows} (tol {ENGINE_GRAD_TOL} at "
                      f"size 2, {EL_GRAD_TOL_3} at size 3)")
            for x in res["grad_gaps"]:
                tol = ENGINE_GRAD_TOL if x[2] == 2 else EL_GRAD_TOL_3
                if not x[3] <= tol:
                    failures.append(f"{gang} rank {r}: step {x[0]}'s "
                                    f"averaged gradients {x[3]:.3e} away "
                                    f"({x[4]}; tol {tol})")
            if [s["step"] for s in res["steps"] if s["epoch"] == 1][-1:] \
                    != [EL_STEPS - 1]:
                failures.append(f"{gang} rank {r}: did not finish at "
                                "epoch 1")
            if dev.type == "cuda" and not all(
                    res["launches"][k] > 0 for k in ("fwd", "dq", "dkv")):
                failures.append(f"{gang} rank {r}: flash launches "
                                f"{res['launches']}")
        # Every step of epoch 1 was checked on its rank 0.
        checked = sorted({x[0] for r in survivors
                          for x in g[r]["grad_gaps"] if x[1] == 1})
        if checked != list(range(checked[0] if checked else 0, EL_STEPS)) \
                or not checked:
            failures.append(f"{gang}: epoch 1's steps checked {checked}")

    # E1: leader failover at full depth.
    e1 = rep["E1"]
    s1 = [r for r in range(3) if r != EL_E1_VICTIM]
    for r in s1:
        res = e1[r]
        commit = dict((c[0], c[1]) for c in res["commits"])
        if res["restored"] != [commit.get(2)]:
            failures.append(f"E1 rank {r}: restored digest "
                            f"{res['restored']} != the step-2 commit's "
                            f"{commit.get(2)}")
        if res["counters"] != {"hvd_elastic_reforms_total": 1,
                               "hvd_leader_failovers_total": 1}:
            failures.append(f"E1 rank {r}: counters {res['counters']}")
    for rec in ("ELASTIC_REFORM", "LEADER_FAILOVER"):
        if rec not in e1["timeline"]:
            failures.append(f"E1: no {rec} on the new rank 0's timeline")
    spans = {r: _el_span(e1[r], e1["kill_at"]) for r in s1}
    _el_print("E1", "the kill of rank 0", spans,
              {r: _el_medians(e1[r]) for r in s1}, card)

    # E2: stall, abort, replay.
    e2 = rep["E2"]
    s2 = [r for r in range(3) if r != EL_E2_VICTIM]
    for r in s2:
        cte = e2[r]["cte"]
        if not cte or cte[0] != [EL_E2_VICTIM]:
            failures.append(f"E2 rank {r}: CollectiveTimeoutError {cte}")
    ins, replay = e2["inputs"], e2["replay"]
    half = torch.tensor(0.5, dtype=torch.float32)
    bits = {n: torch.equal(replay[n], (ins[0][n] + ins[1][n]) * half)
            for n in replay if n in ins[0]}
    # The same inputs recomputed here from the weights the survivors held
    # at step 1 and seed 7's rows.
    model = tfm.init(0, e2["cfg"], device=dev)
    model.load_state_dict({n: t.to(dev) for n, t in e2["p1"].items()})
    tokens, targets = _token_batches(dev, EL_STEPS, B=EL_ROWS,
                                     S=e2["cfg"].max_seq_len,
                                     vocab=e2["cfg"].vocab_size, seed=7)[1]
    again = [_lv_grads(tfm, model, tokens, targets,
                       slice(r * EL_ROWS // 3, (r + 1) * EL_ROWS // 3))
             for r in s2]
    same_bits = all(torch.equal(again[i][n].cpu(), ins[r][n])
                    for i, r in enumerate(s2) for n in ins[r])
    regap = max(_lv_gap(ins[r], {n: x for n, x in again[i].items()})[0]
                for i, r in enumerate(s2))
    del model, again
    if not all(bits.values()):
        failures.append(f"E2: replayed tensors not the retained inputs' "
                        f"average bit for bit: "
                        f"{[n for n, b in bits.items() if not b]}")
    if not replay or not set(replay) <= set(ins[0]):
        failures.append(f"E2: the replay {sorted(replay)} is not of the "
                        "retained inputs")
    if not regap <= ENGINE_GRAD_TOL:
        failures.append(f"E2: the retained inputs {regap:.3e} from their "
                        "recomputation")
    if leftover:
        failures.append(f"E2: shm segments left: {leftover}")
    print(f"elastic E2: CollectiveTimeoutError {e2[0]['cte'][0]} on "
          f"{e2[0]['cte'][1]}, {[round(e2[r]['cte'][2], 3) for r in s2]} s "
          f"after the step's submission (deadline {LV_DEADLINE_S} s); "
          f"{len(replay)} of the step's {len(ins[0])} gradients replayed "
          f"(the aborted one and those failed after it), each equal bit "
          f"for bit to the "
          f"survivors' retained inputs averaged as the engine averages two "
          f"ranks: {all(bits.values())}; the inputs recomputed here from "
          f"the step-1 weights and seed 7's rows: bit for bit {same_bits}, "
          f"largest gap {regap:.3e}; no shm segment left: {not leftover}")
    spans = {r: _el_span(e2[r], e2["stall_at"]) for r in s2}
    _el_print("E2", "the stall of rank 2", spans,
              {r: _el_medians(e2[r]) for r in s2}, card)

    # E3: the joiner.
    e3 = rep["E3"]
    j = e3[EL_E3_JOINER]
    joined = j["entries"][0]["digest"]
    leader = next(e["digest"] for e in e3[0]["entries"] if e["size"] == 3)
    if joined != leader:
        failures.append(f"E3: the joiner's synced state {joined} is not "
                        f"rank 0's {leader}")
    spans = {r: _el_span(e3[r], e3[r].get("notified", e3[r]["detect"]))
             for r in (0, 1)}
    print(f"elastic E3: the joiner started "
          f"{j['t_start'] - e3[0]['step1_at']:.3f} s after rank 0's step "
          f"1, announced itself "
          f"{e3[0].get('notified', e3[0]['detect']) - j['t_start']:.3f} s "
          f"after its start, ran its first step "
          f"{j['steps'][0]['t1'] - j['t_start']:.3f} s after its start; "
          f"its synced digest {joined} equals rank 0's {leader}: "
          f"{joined == leader}")
    _el_print("E3", "the joiner's announcement", spans,
              {r: _el_medians(e3[r]) for r in (0, 1, EL_E3_JOINER)}, card)
    launches = {k: sum(rep[g][r]["launches"][k] for g in EL_GANGS
                       for r in range(3) if isinstance(rep[g].get(r), dict))
                for k in ("fwd", "dq", "dkv")}
    if failures:
        raise AssertionError("elastic: " + "; ".join(failures))
    print(f"elastic: phase wall {time.perf_counter() - t_phase:.1f} s on "
          f"{card}; flash launches of the gangs' steps {launches}")
    return launches


def _el_print(gang, what, spans, medians, card):
    for r, sp in spans.items():
        print(f"elastic {gang} rank {r}: from {what} to the first step of "
              f"epoch 1 {sp['total']:.3f} s: detection {sp['detect']:.3f} "
              f"s, re-form {sp['reform']:.3f} s, state.sync() "
              f"{sp['sync']:.3f} s ({sp['sync_bytes']} bytes, "
              f"{sp['sync_gbs']:.3f} GB/s), replay {sp['replay']:.3f} s, "
              f"first step {sp['first_step']:.3f} s; {card}")
    print(f"elastic {gang}: step medians (ms) before / after the re-form, "
          f"by rank, each process's first step left out: {medians}")


def elastic_rank(rank: int, tmp: str) -> int:
    """One rank of the elastic phase (``--elastic-rank``); writes its
    report to ``<tmp>/<gang><r>.json`` (the new rank 0 its final
    parameters to ``<gang>_final.pt``; E2's survivors their step-1
    gradients, rank 0 its step-1 weights and the replay)."""
    import numpy as np
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common import fault_injection as fi
    from horovod_tpu_torch.models import transformer as tfm
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.parallel.train import default_optimizer
    from horovod_tpu_torch.runner.http_client import KVClient
    from horovod_tpu_torch.telemetry import registry

    t_start = time.time()
    with open(os.path.join(tmp, "config.json")) as fh:
        conf = json.load(fh)
    fields = dict(conf["cfg"])
    fields["compute_dtype"] = getattr(torch, fields["compute_dtype"])
    cfg = tfm.TransformerConfig(**fields)
    dev = torch.device(conf["device"])
    gang = conf["gang"]
    torch.backends.cuda.matmul.allow_tf32 = False
    if dev.type == "cpu":
        torch.set_num_threads(1)
    registry.configure(True)
    joiner = os.environ.get("HVD_ELASTIC_JOINER") == "1"
    if not joiner:
        hvd.init(device=dev, backend="none")
    res = {"rank": rank, "t_start": t_start, "steps": [], "syncs": [],
           "restored": [], "commits": [], "resets": [], "entries": [],
           "grad_gaps": [], "detect": None, "cte": None}

    def epoch():
        return int(os.environ.get("HVD_ELASTIC_EPOCH", "0"))

    model = tfm.init(0, cfg, device=dev)
    opt = default_optimizer(model.parameters())
    batches = _token_batches(dev, EL_STEPS, B=EL_ROWS, S=cfg.max_seq_len,
                             vocab=cfg.vocab_size, seed=7)
    part = {}
    check_launches = {k: 0 for k in fa.launches}

    def repartition():
        r, n = hvd.rank(), hvd.size()
        part["rows"] = slice(r * EL_ROWS // n, (r + 1) * EL_ROWS // n)
        res["resets"].append({"t": time.time(), "size": n})

    class _State(hvd.elastic.TorchState):
        def commit(self):
            self.save()
            res["commits"].append([self.step, _el_digest(model, opt)])
            self.check_host_updates()

        def restore(self):
            super().restore()
            res["restored"].append(_el_digest(model, opt))

        def sync(self, root=0):
            _sync_dev(torch, dev)
            t0 = time.time()
            super().sync(root)
            _sync_dev(torch, dev)
            res["syncs"].append({"t0": t0, "t1": time.time(), "bytes": sum(
                t.numel() * t.element_size()
                for t in _el_tensors(model, opt))})

    state = _State(model, opt, step=0)
    state.register_reset_callbacks([repartition])
    kv = KVClient(os.environ["HVD_RENDEZVOUS_ADDR"],
                  int(os.environ["HVD_RENDEZVOUS_PORT"]))
    notify_key = "elastic/notify"
    if os.environ.get("HVD_ELASTIC_SCOPE_BASE"):
        notify_key = f"{os.environ['HVD_ELASTIC_SCOPE_BASE']}/{notify_key}"

    @hvd.elastic.run(device=dev)
    def train(state):
        if "rows" not in part:
            repartition()
        res["entries"].append({"t": time.time(), "step": state.step,
                               "size": hvd.size(), "rank": hvd.rank(),
                               "digest": _el_digest(model, opt)})
        replayed = hvd.elastic.last_replay_results()
        if replayed and hvd.rank() == 0 and "replayed" not in res:
            res["replayed"] = len(replayed)
            torch.save({n: torch.as_tensor(np.asarray(x))
                        for n, x in replayed.items()},
                       os.path.join(tmp, "E2_replay.pt"))
        try:
            _el_steps(state)
        except Exception:
            # The failure's first sight in the training function.
            if res["detect"] is None:
                res["detect"] = time.time()
            raise

    def _el_steps(state):
        while state.step < EL_STEPS:
            s = state.step
            if gang == "E3" and s == 2 and hvd.size() == 2:
                # Wait for the joiner's announcement, then commit: every
                # rank sees it at the same check, and all interrupt.
                while not kv.get(notify_key):
                    time.sleep(0.01)
                res["notified"] = time.time()
                time.sleep(0.1)
                state.commit()
            tokens, targets = batches[s]
            rows = part["rows"]
            _sync_dev(torch, dev)
            t0 = time.time()
            try:
                opt.zero_grad(set_to_none=True)
                tfm.loss_fn(model, tokens[rows], targets[rows]).backward()
                grads = {n: p.grad for n, p in model.named_parameters()}
                if gang == "E2" and s == 1 and hvd.size() == 3:
                    if rank == EL_E2_VICTIM:
                        with open(os.path.join(tmp, "E2_stall_at"),
                                  "w") as fh:
                            fh.write(repr(time.time()))
                        fi.configure({"faults": [{"site": "shm.stall",
                                                  "kind": "stall",
                                                  "stall_s": 600}]})
                    else:
                        torch.save({n: g.cpu() for n, g in grads.items()},
                                   os.path.join(tmp, f"E2_in{rank}.pt"))
                        if rank == 0:
                            torch.save({n: p.detach().cpu() for n, p in
                                        model.named_parameters()},
                                       os.path.join(tmp, "E2_p1.pt"))
                t_sub = time.monotonic()
                handles = [hvd.allreduce_async(g, name=n, op=hvd.Average)
                           for n, g in grads.items()]
                avg = {n: hvd.synchronize(h) for n, h in
                       zip(grads, handles)}
            except hvd.CollectiveTimeoutError as e:
                res["cte"] = [e.ranks, e.tensor_name,
                              time.monotonic() - t_sub]
                raise
            for n, p in model.named_parameters():
                p.grad = avg[n]
            check_s = 0.0
            if hvd.rank() == 0:
                tc = time.time()
                gap = _one_process_gap(tfm, model, tokens, targets,
                                       check_launches)
                res["grad_gaps"].append([s, epoch(), hvd.size(), *gap])
                check_s = time.time() - tc
            opt.step()
            _sync_dev(torch, dev)
            t1 = time.time()
            res["steps"].append({"step": s, "epoch": epoch(),
                                 "size": hvd.size(),
                                 "ms": (t1 - t0 - check_s) * 1e3,
                                 "t1": t1})
            if gang == "E1" and rank == EL_E1_VICTIM and s == 2:
                with open(os.path.join(tmp, "E1_kill_at"), "w") as fh:
                    fh.write(repr(time.time()))
            fi.fire("train.step", str(s))
            state.step += 1
            if state.step % conf["commit"] == 0:
                state.commit()
            if gang == "E3" and rank == 0 and s == 1:
                res["step1_at"] = time.time()
                with open(os.path.join(tmp, "E3_step1"), "w"):
                    pass

    fa.reset_launch_counts()
    try:
        train(state)
        res["final_digest"] = _el_digest(model, opt)
        snap = hvd.metrics_snapshot().get("counters", {})
        res["counters"] = {k: int(snap.get(k, 0)) for k in (
            "hvd_elastic_reforms_total", "hvd_leader_failovers_total")}
        res["launches"] = {k: n - check_launches[k]
                           for k, n in fa.launches.items()}
        res["epoch"] = epoch()
        if hvd.rank() == 0:
            torch.save({n: p.detach().cpu()
                        for n, p in model.named_parameters()},
                       os.path.join(tmp, f"{gang}_final.pt"))
        with open(os.path.join(tmp, f"{gang}{rank}.json"), "w") as fh:
            json.dump(res, fh)
    finally:
        fi.clear()
        hvd.shutdown()
    return 0


# The torch-api phase: the engine phase's two ranks (ENGINE_RANKS, child
# processes sharing cuda:0 through the port's RendezvousServer, with no
# torch process group) train the full-width flagship through the classic
# front-end, ``import horovod_tpu_torch.torch as hvd``: rank 0 from seed 0
# and rank 1 from seed 1, made rank 0's bit for bit by
# ``broadcast_parameters`` and ``broadcast_optimizer_state``; a hook-driven
# ``DistributedOptimizer`` over ``torch.optim.AdamW(1e-3, wd 0.01)`` for
# ENGINE_STEPS steps on four rows a rank of the engine phase's batches
# (seed 7), its allreduces fired by post-accumulate hooks during
# ``backward()``.  Held against a one-process twin on cuda:0 (seed 0,
# AdamW on all eight rows, after the same zero-gradient step that
# ``broadcast_optimizer_state`` makes on the root): the step-0 averaged
# gradients within ENGINE_GRAD_TOL, the parameters after the steps within
# TA_PARAM_TOL (|p - p_one| / |p_one|, the largest), the ranks equal bit for
# bit.  Then: one step with ``backward_passes_per_step=2`` over two
# half-batches (from seed 0, a fresh AdamW) against the twin's first step on
# the same rows (TA_ACC_PARAM_TOL); the Adasum delta optimizer at two
# layers, one step, with fusion off, against a float64 oracle of Adasum of
# the two ranks' own deltas (each element within TA_ADASUM_ULPS fp32 ulps
# of fp32(start + fp32(oracle)): the engine rounds its float64 result to
# fp32 once and the optimizer adds it in fp32 once, so the two agree bit
# for bit but where a float64 sum in another order rounds the other way);
# and the
# gradients' ``grouped_allreduce`` compiled with
# ``torch.compile(fullgraph=True)`` (the custom ops of ``ops/bridge.py``)
# against the eager grouped allreduce, bit for bit, with no graph break.
# TA_PARAM_TOL and TA_ACC_PARAM_TOL are about twice the first H100 run's
# readings, 7.488e-03 after three steps and 7.518e-03 after the
# accumulated step (NVIDIA H100 80GB HBM3, 700.00 W; the twin's first
# step reads the same AdamW sign effect as ENGINE_PARAM_TOL's).
TA_PARAM_TOL = 1.5e-2
TA_ACC_PARAM_TOL = 1.5e-2
TA_ADASUM_ULPS = 1.0
TA_TIMEOUT_S = 600


def _ta_twin(tfm, cfg, dev, batches):
    """The one-process twin: seed 0, AdamW after the root's zero-gradient
    step (its parameters kept), ``len(batches)`` steps on all the rows.
    Returns the step-0 gradients and the last parameters."""
    with _INPROC:
        return _ta_twin_steps(tfm, cfg, dev, batches)


def _ta_twin_steps(tfm, cfg, dev, batches):
    import torch

    model = tfm.init(0, cfg, device=dev)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=0.01)
    kept = [p.detach().clone() for p in model.parameters()]
    for p in model.parameters():
        p.grad = torch.zeros_like(p)
    opt.step()
    with torch.no_grad():
        for p, k in zip(model.parameters(), kept):
            p.copy_(k)
    del kept
    for s, (tokens, targets) in enumerate(batches):
        opt.zero_grad(set_to_none=True)
        tfm.loss_fn(model, tokens, targets).backward()
        if s == 0:
            grads = {n: p.grad.detach().clone()
                     for n, p in model.named_parameters()}
        opt.step()
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    return grads, params


def _rel_gaps(got, want, dev):
    gaps = {n: float((got[n].to(dev) - w).norm()
                     / w.norm().clamp_min(1e-30)) for n, w in want.items()}
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def run_torch_api(hvd, tfm, fa, dev, card, engine=None,
                  timeout=TA_TIMEOUT_S):
    """The torch-api phase (see TA_PARAM_TOL): the twins here, the ranks
    (``--torch-api-rank R``), then the checks; ``engine``, the engine
    phase's reports, for its step medians.  Returns the flash launches of
    rank 0's training steps."""
    import tempfile

    import torch

    t_phase = time.perf_counter()
    cfg = _flagship_cfg(tfm)
    B = 8
    batches = _token_batches(dev, ENGINE_STEPS, B=B, S=cfg.max_seq_len,
                             vocab=cfg.vocab_size, seed=7)
    ref_grads, ref_params = _ta_twin(tfm, cfg, dev, batches)
    # The accumulation step's twin: a fresh AdamW, one step on all rows.
    model = tfm.init(0, cfg, device=dev)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=0.01)
    tfm.loss_fn(model, *batches[0]).backward()
    opt.step()
    acc_params = {n: p.detach().clone() for n, p in model.named_parameters()}
    del model, opt, batches
    torch.cuda.empty_cache()
    twin_s = time.perf_counter() - t_phase

    with tempfile.TemporaryDirectory() as tmp:
        fields = {f.name: getattr(cfg, f.name)
                  for f in dataclasses.fields(cfg)}
        fields["compute_dtype"] = str(cfg.compute_dtype).split(".")[1]
        with open(os.path.join(tmp, "config.json"), "w") as fh:
            json.dump({"cfg": fields, "device": str(dev), "rows": B,
                       "steps": ENGINE_STEPS}, fh)
        t0 = time.perf_counter()
        _spawn_ranks("--torch-api-rank", ENGINE_RANKS, tmp, lambda r: dict(
            HVD_RANK=str(r), HVD_SIZE=str(ENGINE_RANKS),
            HVD_LOCAL_RANK=str(r), HVD_LOCAL_SIZE=str(ENGINE_RANKS)),
            timeout, "torch-api")
        wall = time.perf_counter() - t0
        ranks = []
        for r in range(ENGINE_RANKS):
            with open(os.path.join(tmp, f"rank{r}.json")) as fh:
                ranks.append(json.load(fh))
        got = torch.load(os.path.join(tmp, "rank0.pt"))

    failures = []
    g_gap, g_where = _rel_gaps(got["grads0"], ref_grads, dev)
    p_gap, p_where = _rel_gaps(got["params"], ref_params, dev)
    ag_gap, ag_where = _rel_gaps(got["acc_grads"], ref_grads, dev)
    ap_gap, ap_where = _rel_gaps(got["acc_params"], acc_params, dev)
    r0 = ranks[0]
    print(f"torch-api: {ENGINE_RANKS} ranks on {dev} through "
          f"horovod_tpu_torch.torch (hook-driven DistributedOptimizer over "
          f"AdamW), {wall:.1f} s wall, twins {twin_s:.1f} s; rank 1 started "
          f"from other weights: {r0['started_apart']}; after "
          f"broadcast_parameters and broadcast_optimizer_state "
          f"({r0['bcast_ms']:.1f} ms) the parameters are rank 0's bit for "
          f"bit: {[r['bcast_params_equal'] for r in ranks]}, the optimizer "
          f"state: {[r['bcast_state_equal'] for r in ranks]}; largest "
          f"|g - g_one| / |g_one| of the averaged step-0 gradients "
          f"{g_gap:.3e} ({g_where}; tol {ENGINE_GRAD_TOL}); largest "
          f"|p - p_one| / |p_one| after {ENGINE_STEPS} steps {p_gap:.3e} "
          f"({p_where}; tol {TA_PARAM_TOL}); the ranks' parameters equal "
          f"bit for bit: {[r['params_equal'] for r in ranks]}; {card}")
    print(f"torch-api: backward_passes_per_step=2 over two half-batches: "
          f"gradients {ag_gap:.3e} ({ag_where}; tol {ENGINE_GRAD_TOL}), "
          f"parameters after the step {ap_gap:.3e} ({ap_where}; tol "
          f"{TA_ACC_PARAM_TOL}) from the twin's first step on the same rows;"
          f" ranks equal {[r['acc_equal'] for r in ranks]}")
    print(f"torch-api: Adasum delta optimizer at {r0['adasum_layers']} "
          f"layers, one step, fusion off: against the float64 oracle of "
          f"Adasum of the ranks' own deltas rounded as the optimizer rounds "
          f"(fp32(p0 + fp32(oracle))), the largest gap "
          f"{r0['adasum_err']:.3f} fp32 ulps ({r0['adasum_where']}; tol "
          f"{TA_ADASUM_ULPS}), {r0['adasum_off']} of "
          f"{r0['adasum_elements']} elements not bit for bit; ranks equal "
          f"{[r['adasum_equal'] for r in ranks]}")
    print(f"torch-api: the gradients' grouped_allreduce under "
          f"torch.compile(fullgraph=True): bit for bit the eager grouped "
          f"allreduce's {[r['bridge_equal'] for r in ranks]}, on the card "
          f"{[r['bridge_on_card'] for r in ranks]}, graph breaks "
          f"{[r['graph_breaks'] for r in ranks]}; first call (compiling) "
          f"{r0['bridge_first_ms']:.1f} ms, then compiled "
          f"{r0['bridge_ms']:.1f} ms against eager {r0['eager_ms']:.1f} ms "
          f"for {r0['grad_bytes']} bytes; {card}")
    if not g_gap <= ENGINE_GRAD_TOL:
        failures.append("the averaged step-0 gradients")
    if not p_gap <= TA_PARAM_TOL:
        failures.append(f"the parameters after {ENGINE_STEPS} steps")
    if not ag_gap <= ENGINE_GRAD_TOL:
        failures.append("the accumulated gradients")
    if not ap_gap <= TA_ACC_PARAM_TOL:
        failures.append("the parameters after the accumulated step")
    if not r0["adasum_err"] <= TA_ADASUM_ULPS:
        failures.append("the Adasum step against its oracle")
    if not r0["started_apart"]:
        failures.append("rank 1 started from rank 0's weights")
    want_launches = {"fwd": 2 * cfg.n_layers * ENGINE_STEPS,
                     "dq": cfg.n_layers * ENGINE_STEPS,
                     "dkv": cfg.n_layers * ENGINE_STEPS, "split": 0}
    for r, res in enumerate(ranks):
        st = res["steps"]
        med = statistics.median(s["ms"] for s in st)
        tail = statistics.median(s["tail_ms"] for s in st)
        eng = f"{statistics.median(s['ms'] for s in engine[r]['steps']):.1f}" \
            if engine else "not measured"
        print(f"torch-api rank {r}: step ms {[round(s['ms'], 1) for s in st]}"
              f", median {med:.1f} against the engine phase's explicit "
              f"per-parameter allreduce_async on the same rows {eng}; the end "
              f"of backward() to the end of step() (the allreduce the hooks "
              f"did not hide, and the update) "
              f"{[round(s['tail_ms'], 1) for s in st]}, median {tail:.1f}; "
              f"backward() {[round(s['backward_ms'], 1) for s in st]}; "
              f"flash launches {res['launches']} "
              f"({ {k: n / ENGINE_STEPS for k, n in res['launches'].items()} }"
              f" a step); {card}")
        for key, what in (("bcast_params_equal", "the broadcast parameters"),
                          ("bcast_state_equal", "the broadcast state"),
                          ("params_equal", "the trained parameters"),
                          ("acc_equal", "the accumulated step's parameters"),
                          ("adasum_equal", "the Adasum step's parameters"),
                          ("bridge_equal", "the compiled reduction's bits"),
                          ("bridge_on_card", "the compiled reduction's "
                                             "device")):
            if not res[key]:
                failures.append(f"rank {r}: {what}")
        if res["graph_breaks"]:
            failures.append(f"rank {r}: {res['graph_breaks']} graph breaks")
        if dev.type == "cuda" and res["launches"] != want_launches:
            failures.append(f"rank {r}: flash launches {res['launches']} != "
                            f"{want_launches}")
        if not all(math.isfinite(s["loss"]) for s in st):
            failures.append(f"rank {r}: a loss is not finite")
    if "profile" in r0:
        pr = r0["profile"]
        print(f"torch-api profile (rank 0, one more step): kernels "
              f"{pr['busy_ms']:.2f} ms in {pr['launches']} launches, of them "
              f"flash {pr['flash']}; copies and sets {pr['copy_ms']:.2f} ms "
              f"in {pr['copies']}; the profiled step took "
              f"{pr['wall_ms']:.2f} ms; {card}")
    print(f"torch-api: phase wall {time.perf_counter() - t_phase:.1f} s on "
          f"{card}")
    if failures:
        raise AssertionError("torch-api: " + "; ".join(failures))
    return ranks[0]["launches"]


def _ta_digest(tree):
    import numpy as np

    from horovod_tpu_torch.integrity.audit import fingerprint

    return int(np.array([fingerprint(tree)[0]], np.uint64).view(np.int64)[0])


def torch_api_rank(rank: int, tmp: str) -> int:
    """One rank of the torch-api phase (``--torch-api-rank``): see
    TA_PARAM_TOL.  Writes its readings to ``<tmp>/rank<r>.json`` and rank 0
    its gradients and parameters to ``rank0.pt``."""
    import copy

    import numpy as np
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import horovod_tpu_torch.torch as hvd
    from horovod_tpu_torch import basics
    from horovod_tpu_torch.models import transformer as tfm
    from horovod_tpu_torch.ops import bridge
    from horovod_tpu_torch.ops import flash_attention as fa

    with open(os.path.join(tmp, "config.json")) as fh:
        conf = json.load(fh)
    fields = dict(conf["cfg"])
    fields["compute_dtype"] = getattr(torch, fields["compute_dtype"])
    cfg = tfm.TransformerConfig(**fields)
    dev = torch.device(conf["device"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # The gradients go through the eager engine, which needs no
    # torch.distributed group (NCCL refuses two ranks on one card).
    hvd.init(device=dev, backend="none")
    res, save = {"rank": rank}, {}
    try:
        size = hvd.size()
        rows = slice(rank * conf["rows"] // size,
                     (rank + 1) * conf["rows"] // size)

        def adamw(params):
            return torch.optim.AdamW(params, lr=1e-3, weight_decay=0.01)

        def agree(value, name):
            got = hvd.allgather(torch.tensor([value]), name=name)
            return bool(len(set(got.tolist())) == 1)

        def state_tree(opt):
            return {f"{i}.{k}": v for i, st in opt.state_dict()["state"]
                    .items() for k, v in st.items() if torch.is_tensor(v)}

        # -- from unequal starts to rank 0's weights and state
        model = tfm.init(rank, cfg, device=dev)  # rank 1: another seed
        opt = hvd.DistributedOptimizer(
            adamw(model.parameters()),
            named_parameters=model.named_parameters())
        res["started_apart"] = not agree(_ta_digest(model.state_dict()),
                                         "ta.digest.seed")
        _sync_dev(torch, dev)
        t0 = time.perf_counter()
        hvd.broadcast_parameters(model.state_dict(), root_rank=0)
        hvd.broadcast_optimizer_state(opt, root_rank=0)
        _sync_dev(torch, dev)
        res["bcast_ms"] = (time.perf_counter() - t0) * 1e3
        res["bcast_params_equal"] = agree(_ta_digest(model.state_dict()),
                                          "ta.digest.bcast")
        res["bcast_state_equal"] = agree(_ta_digest(state_tree(opt)),
                                         "ta.digest.state")

        # -- the steps: the hooks fire the allreduces during backward()
        batches = _token_batches(dev, conf["steps"], B=conf["rows"],
                                 S=cfg.max_seq_len, vocab=cfg.vocab_size,
                                 seed=7)
        steps = []
        fa.reset_launch_counts()
        for s, (tokens, targets) in enumerate(batches):
            _sync_dev(torch, dev)
            t0 = time.perf_counter()
            opt.zero_grad(set_to_none=True)
            loss = tfm.loss_fn(model, tokens[rows], targets[rows])
            loss.backward()
            t1 = time.perf_counter()
            opt.step()
            _sync_dev(torch, dev)
            t2 = time.perf_counter()
            steps.append(dict(step=s, loss=float(loss.detach()),
                              ms=(t2 - t0) * 1e3,
                              backward_ms=(t1 - t0) * 1e3,
                              tail_ms=(t2 - t1) * 1e3))
            if s == 0:
                save["grads0"] = {n: p.grad.detach().cpu()
                                  for n, p in model.named_parameters()}
        res["launches"] = dict(fa.launches)
        res["steps"] = steps
        res["params_equal"] = agree(_ta_digest(model.state_dict()),
                                    "ta.digest.final")
        save["params"] = {n: p.detach().cpu()
                          for n, p in model.named_parameters()}

        # -- one more step, profiled on rank 0: launches and busy time
        def one_step():
            opt.zero_grad(set_to_none=True)
            tfm.loss_fn(model, batches[0][0][rows],
                        batches[0][1][rows]).backward()
            opt.step()

        if rank == 0 and dev.type == "cuda":
            t0 = time.perf_counter()
            prof_rows = _profile_rows(one_step, reps=1, warmup=0)
            copies = [e for e in prof_rows
                      if e.key.startswith(("Memcpy", "Memset"))]
            kernels = [e for e in prof_rows if e not in copies]
            res["profile"] = dict(
                wall_ms=(time.perf_counter() - t0) * 1e3,
                busy_ms=sum(_dev_us(e) for e in kernels) / 1e3,
                launches=sum(e.count for e in kernels),
                copy_ms=sum(_dev_us(e) for e in copies) / 1e3,
                copies=sum(e.count for e in copies),
                flash=sum(e.count for e in kernels if re.search(
                    r"\b(fwd|dq|dkv)(_wgmma)?_kernel<", e.key)))
        else:
            one_step()
            _sync_dev(torch, dev)

        # -- the bridge: the gradients' reduction compiled
        from torch._dynamo.utils import counters

        grads = [p.grad for p in model.parameters()]
        reduce = torch.compile(lambda gs: bridge.grouped_allreduce(
            gs, name="ta.bridge"), fullgraph=True)
        _sync_dev(torch, dev)
        t0 = time.perf_counter()
        reduce(grads)
        _sync_dev(torch, dev)
        res["bridge_first_ms"] = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        compiled = reduce(grads)
        _sync_dev(torch, dev)
        res["bridge_ms"] = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        eager = hvd.grouped_allreduce(grads, name="ta.eager")
        _sync_dev(torch, dev)
        res["eager_ms"] = (time.perf_counter() - t0) * 1e3
        res["grad_bytes"] = sum(g.numel() * g.element_size() for g in grads)
        res["bridge_equal"] = all(
            torch.equal(a.view(torch.int32), b.view(torch.int32))
            for a, b in zip(compiled, eager))
        res["bridge_on_card"] = all(t.device == dev for t in compiled)
        res["graph_breaks"] = sum(counters["graph_break"].values())
        del grads, compiled, eager, reduce, opt, model
        if dev.type == "cuda":
            torch.cuda.empty_cache()

        # -- gradients accumulated over two half-batches
        model = tfm.init(0, cfg, device=dev)
        opt = hvd.DistributedOptimizer(
            adamw(model.parameters()),
            named_parameters=model.named_parameters(),
            backward_passes_per_step=2)
        tokens, targets = batches[0]
        half = (rows.stop - rows.start) // 2
        opt.zero_grad(set_to_none=True)
        for lo in (rows.start, rows.start + half):
            part = slice(lo, lo + half)
            (tfm.loss_fn(model, tokens[part], targets[part]) / 2).backward()
        opt.step()
        save["acc_grads"] = {n: p.grad.detach().cpu()
                             for n, p in model.named_parameters()}
        save["acc_params"] = {n: p.detach().cpu()
                              for n, p in model.named_parameters()}
        res["acc_equal"] = agree(_ta_digest(model.state_dict()),
                                 "ta.digest.acc")
        del opt, model
        if dev.type == "cuda":
            torch.cuda.empty_cache()

        # -- Adasum: the delta optimizer at two layers, one step
        cfg2 = dataclasses.replace(cfg, n_layers=2)
        eng = basics._engine()
        threshold = eng.fusion_threshold
        eng.fusion_threshold = 0  # one response a tensor: Adasum per tensor
        try:
            model = tfm.init(rank, cfg2, device=dev)
            opt = hvd.DistributedOptimizer(
                adamw(model.parameters()),
                named_parameters=model.named_parameters(), op=hvd.Adasum)
            start = {n: p.detach().clone()
                     for n, p in model.named_parameters()}
            tfm.loss_fn(model, tokens[rows], targets[rows]).backward()
            # This rank's own delta: the same AdamW step on a copy.
            local = copy.deepcopy(model)
            plain = adamw(local.parameters())
            for p, q in zip(model.parameters(), local.parameters()):
                q.grad = p.grad.detach().clone()
            plain.step()
            opt.step()
            worst, err, off = None, 0.0, 0
            for (n, p), q in zip(model.named_parameters(),
                                 local.parameters()):
                both = hvd.allgather((q.detach() - start[n]).unsqueeze(0),
                                     name=f"ta.adasum.{n}")
                a = both[0].double().flatten()
                b = both[1].double().flatten()
                dot, an, bn = float(a @ b), float(a @ a), float(b @ b)
                want = (1.0 - dot / (2.0 * an) if an > 0 else 1.0) * a + \
                    (1.0 - dot / (2.0 * bn) if bn > 0 else 1.0) * b
                # The engine rounds the float64 Adasum to fp32 once, and
                # the optimizer adds it to the start in fp32 once: the
                # oracle rounded the same way, in ulps of the result (a
                # float64 sum in another order may round the other way).
                got = p.detach().flatten()
                sim = start[n].flatten() + want.float()
                ulp = torch.nextafter(sim.abs(), torch.full_like(
                    sim, math.inf)) - sim.abs()
                e = float(((got - sim).abs() / ulp).max())
                off += int((got != sim).sum())
                if worst is None or e > err:
                    worst, err = n, e
            res["adasum_err"], res["adasum_where"] = err, worst
            res["adasum_off"] = off
            res["adasum_elements"] = sum(p.numel()
                                         for p in model.parameters())
            res["adasum_layers"] = cfg2.n_layers
            res["adasum_equal"] = agree(_ta_digest(model.state_dict()),
                                        "ta.digest.adasum")
        finally:
            eng.fusion_threshold = threshold
        if rank == 0:
            torch.save(save, os.path.join(tmp, "rank0.pt"))
        with open(os.path.join(tmp, f"rank{rank}.json"), "w") as fh:
            json.dump(res, fh)
    finally:
        hvd.shutdown()
    return 0


def _sync_dev(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


REGISTERS = {}


def _registers(kernel, D, *flags):
    """The registers of ``<kernel>_wgmma_kernel`` at head dim D with its
    bool template arguments ``flags``, as ptxas reported them."""
    from horovod_tpu_torch.ops import flash_attention as fa

    key = f"{kernel}_wgmma_kernelILi{fa.kernel_head_dim(D)}E" + "".join(
        f"Lb{int(f)}E" for f in flags)
    regs = [r for name, r in REGISTERS.items() if key in name]
    return (f"{regs[0]} registers" if len(regs) == 1
            else "registers not reported")


def _ptxas_report(log):
    """Registers and spills of each kernel, from ``ptxas -v``."""
    name, spills = None, 0
    for line in log.splitlines():
        if "Function properties for " in line:
            name = line.split("Function properties for ", 1)[1].strip()
        elif name and "spill stores" in line:
            if not line.strip().startswith("0 bytes stack frame, 0 bytes "
                                           "spill stores, 0 bytes spill"):
                spills += 1
                print(f"build: spills in {name}: {line.strip()}")
        elif name and "Used " in line and "registers" in line:
            regs = line.split("Used ", 1)[1].split(" registers")[0]
            REGISTERS[name] = int(regs)
            kname = re.search(r"\d([a-z]+(?:_wgmma)?_kernel)I", name)
            short = name.split("N_", 1)[-1][-70:]
            print(f"build: {regs} registers  "
                  f"{kname.group(1) if kname else ''}  {short}")
            name = None
    print(f"build: {spills} kernels with register spills")


def main() -> int:
    if sys.argv[1:2] == ["--engine-rank"]:  # a rank of the engine phase
        return engine_rank(int(sys.argv[2]), sys.argv[3])
    if sys.argv[1:2] == ["--dataplane-rank"]:  # a data-plane phase rank
        return dataplane_rank(int(sys.argv[2]), sys.argv[3])
    if sys.argv[1:2] == ["--liveness-rank"]:  # a liveness phase rank
        return liveness_rank(int(sys.argv[2]), sys.argv[3])
    if sys.argv[1:2] == ["--elastic-rank"]:  # an elastic phase rank
        return elastic_rank(int(sys.argv[2]), sys.argv[3])
    if sys.argv[1:2] == ["--serve-gang-rank"]:  # a serving gang's rank
        return serve_gang_rank(sys.argv[2])
    if sys.argv[1:2] == ["--torch-api-rank"]:  # a torch-api phase rank
        return torch_api_rank(int(sys.argv[2]), sys.argv[3])
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import resnet as rn
    from horovod_tpu_torch.models import transformer as tfm
    from horovod_tpu_torch.ops import _build
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.parallel import ring_attention as ra
    from horovod_tpu_torch.parallel.mesh import make_mesh

    card = _sh(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"]).splitlines()[0]
    nvcc = "; ".join(_sh([_build._nvcc(), "--version"]).splitlines()[-2:])
    print(f"card: {card} | torch {torch.__version__} "
          f"(CUDA {torch.version.cuda}) | nvcc: {nvcc}")
    peak_name, peaks = _peaks(torch.cuda.get_device_name(0))
    print(f"peaks ({peak_name}): bf16 {peaks[0] / 1e12:g}, tf32 "
          f"{peaks[1] / 1e12:g}, fp32 {peaks[2] / 1e12:g} TFLOP/s, "
          f"{peaks[3] / 1e12:g} TB/s")

    if sys.argv[1:2] == ["--estimator-only"]:
        # The estimator phase alone (phase 14), for a quick reading.
        run_estimator(card)
        print(card)
        return 0
    if sys.argv[1:2] == ["--examples-only"]:
        # The kernels' build, then the examples phase alone (phase 15),
        # for a quick reading.
        _build.lib()
        run_examples(card)
        print(card)
        return 0
    if sys.argv[1:2] == ["--serve-gang-only"]:
        # The serve phase, both serving gangs and the control plane's
        # curve alone (phases 10 and 11), for a quick reading.
        torch.backends.cuda.matmul.allow_tf32 = False
        dev = torch.device("cuda", 0)
        serve_step_ms, alone = run_serve(tfm, dev, card)
        torch.cuda.empty_cache()
        run_serve_gang(tfm, dev, card, serve_step_ms, alone)
        torch.cuda.empty_cache()
        run_serve_gang_tp(tfm, dev, card, str(dev))
        run_ctrl_sim(card)
        print(f"chip_smoke: total wall time "
              f"{time.perf_counter() - t_start:.1f} s")
        print(card)
        return 0
    # The native core builds with g++ while nvcc builds the kernels.
    native_rec = start_native_build()
    t0 = time.perf_counter()
    _build.lib()
    print(f"build: {time.perf_counter() - t0:.1f} s -> {_build.library_path()}")
    if sys.argv[1:2] == ["--native-only"]:
        # The engine phase (over shm, then over TCP) and the native phase
        # alone (phases 6 and 13), for a quick reading of the cores in one
        # call.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dev = torch.device("cuda", 0)
        plain = run_engine(hvd, tfm, fa, dev, card)
        torch.cuda.empty_cache()
        # The Python engine over TCP too: the native core's medium.
        tcp = run_engine(hvd, tfm, fa, dev, card,
                         knobs={"HVD_SHM_DISABLE": "1"})
        torch.cuda.empty_cache()
        run_native(hvd, tfm, fa, dev, card, plain, tcp=tcp,
                   build=native_rec)
        print(f"chip_smoke: total wall time "
              f"{time.perf_counter() - t_start:.1f} s")
        print(card)
        return 0
    if _build.build_log:
        _ptxas_report(_build.build_log)
    else:
        print("build: library built earlier; no ptxas report")
    check_sass(_build.library_path())

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    # (B, S, H, D, dtype, causal, with dlse): the flagship, then two ragged.
    shapes = ((8, 1024, 16, 64, torch.bfloat16, True, False),
              (2, 1000, 8, 128, torch.bfloat16, False, True),
              (2, 1000, 8, 32, torch.float32, False, True))
    # The flagship's attention in fp32: the fp32 step phase's shape.
    f32_flagship = (8, 1024, 16, 64, torch.float32, True, False)
    # The ring hop's variants at the shard shape: the self-block (causal)
    # and the other hops (non-causal), fp32 output and dO, with dlse.
    sp = SP_SHAPE
    ring_shapes = {c: (sp["B"], sp["S_local"], sp["H"], sp["D"],
                       torch.bfloat16, c, True) for c in (True, False)}
    # Head dims off the powers of two (width 128 with zero columns) and the
    # widest (256), ragged, with dlse, on the flash route and the lse route.
    dim_shapes = ((2, 1000, 8, 96, torch.bfloat16, True, True),
                  (2, 1000, 8, 256, torch.bfloat16, False, True))
    # The pipelined flagship's microbatch: B 8 / PP_MICRO rows.
    micro = (8 // PP_MICRO, 1024, 16, 64, torch.bfloat16, True, False)
    # An engine-phase rank's rows: B 8 / ENGINE_RANKS.
    engine_rows = (8 // ENGINE_RANKS, 1024, 16, 64, torch.bfloat16, True,
                   False)
    # An elastic rank's rows after a shrink to two: EL_ROWS / 2.
    elastic_rows = (EL_ROWS // 2, 1024, 16, 64, torch.bfloat16, True, False)
    for shape in shapes + (f32_flagship, micro, engine_rows,
                           elastic_rows) + dim_shapes:
        check_kernels(fa, *shape, peaks, dev, timed=False)
    for shape in tuple(ring_shapes.values()) + (shapes[2],) + dim_shapes:
        check_kernels(fa, *shape, peaks, dev, timed=False, lse_route=True)

    hvd.init()
    try:
        # Every timed step runs before the first profiler.
        resnet = run_resnet(hvd, rn, fa, make_mesh, dev, card)
        counts, step_ms, steps, slice_prof = run_slice(hvd, tfm, fa,
                                                       make_mesh, dev, card)
        moe_counts, moe_ms, moe_steps, moe_prof = run_moe(
            hvd, tfm, fa, make_mesh, dev, card)
        torch.cuda.empty_cache()
        pp_counts, pp_ms, pp_steps, pp_prof = run_pipeline(hvd, tfm, fa,
                                                           dev, card)
        _profile_step(*pp_prof, what="pp profile")
        del pp_prof
        torch.cuda.empty_cache()
        _profile_step(*moe_prof, what="moe profile")
        print(f"moe profile: peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        del moe_prof
        torch.cuda.empty_cache()
        _profile_step(*slice_prof)
        del slice_prof
        profile_resnet(*resnet, card)
        del resnet
        run_mnist(hvd, dev)
        run_guard(hvd, dev)
        torch.cuda.empty_cache()
        run_zero1(hvd, tfm, make_mesh, dev)
        torch.cuda.empty_cache()
        run_adasum(tfm, dev, card)
        torch.cuda.empty_cache()
        f32_run = run_fp32_step(hvd, tfm, fa, dev)
        torch.cuda.empty_cache()
        run_audit(hvd, tfm, make_mesh, dev, card)
    finally:
        hvd.shutdown()
    torch.cuda.empty_cache()
    sp_run = run_sp(fa, ra, dev, card)
    torch.cuda.empty_cache()
    serve_step_ms, alone = run_serve(tfm, dev, card)
    torch.cuda.empty_cache()
    # The two phases that time the host run alone.
    run_ctrl_sim(card)
    run_estimator(card)

    def engine_lane():
        plain = run_engine(hvd, tfm, fa, dev, card)
        torch.cuda.empty_cache()
        ta_counts = run_torch_api(hvd, tfm, fa, dev, card, engine=plain)
        torch.cuda.empty_cache()
        run_native(hvd, tfm, fa, dev, card, plain, build=native_rec)
        torch.cuda.empty_cache()
        tel = run_engine(hvd, tfm, fa, dev, card, steps=TEL_STEPS,
                         telemetry=True)
        torch.cuda.empty_cache()
        for r in range(ENGINE_RANKS):
            med = {(run, k): statistics.median(s[k] for s in got[r]["steps"])
                   for run, got in (("tel", tel), ("plain", plain))
                   for k in ("ms", "sync_ms")}
            print(f"telemetry rank {r}: step median with every knob on "
                  f"{med['tel', 'ms']:.1f} ms, synchronize "
                  f"{med['tel', 'sync_ms']:.1f} ms, against the engine "
                  f"phase's {med['plain', 'ms']:.1f} ms and "
                  f"{med['plain', 'sync_ms']:.1f} ms; {card}")
        run_engine(hvd, tfm, fa, dev, card, knobs=LV_KNOBS)
        return ta_counts

    def fault_lane():
        run_dataplane(tfm, dev, card)
        torch.cuda.empty_cache()
        run_liveness(tfm, dev, card)
        torch.cuda.empty_cache()
        return run_elastic(tfm, fa, dev, card)

    def serving_lane():
        run_serve_gang(tfm, dev, card, serve_step_ms, alone)
        torch.cuda.empty_cache()
        run_serve_gang_tp(tfm, dev, card, str(dev))
        run_examples(card)

    lanes = _run_lanes({"engine": engine_lane, "fault": fault_lane,
                        "serving": serving_lane})
    ta_counts, el_counts = lanes["engine"], lanes["fault"]
    torch.cuda.empty_cache()

    # Timed after the slice, so that no profiler has run before the steps
    # are timed.
    flagship = check_kernels(fa, *shapes[0], peaks, dev)
    for shape in shapes[1:]:
        check_kernels(fa, *shape, peaks, dev)
    ratio = {k: m["ms"] / m["library_ms"] for k, m in flagship.items()}
    print(f"kernels: flagship forward {ratio['fwd']:.2f}x SDPA's forward; "
          f"dK/dV {ratio['dkv']:.2f}x and dQ {ratio['dq']:.2f}x SDPA's "
          "whole backward")
    attn_ms = sum(flagship[k]["ms"] * counts[k] / steps
                  for k in ("fwd", "dq", "dkv"))
    print(f"slice: attention kernels {attn_ms:.2f} ms of the {step_ms:.2f} ms "
          f"step (each kernel's flagship time x its launches per step)")

    mb = check_kernels(fa, *micro, peaks, dev)
    pp_attn = sum(mb[k]["ms"] * pp_counts[k] / pp_steps
                  for k in ("fwd", "dq", "dkv"))
    print(f"pp: attention kernels {pp_attn:.2f} ms of the {pp_ms:.2f} ms "
          f"step (each kernel's microbatch time x its launches per step)")

    el = check_kernels(fa, *elastic_rows, peaks, dev)
    ta = check_kernels(fa, *engine_rows, peaks, dev)
    f32 = check_kernels(fa, *f32_flagship, peaks, dev)
    for shape in dim_shapes:
        check_kernels(fa, *shape, peaks, dev)
        check_kernels(fa, *shape, peaks, dev, lse_route=True)
    ring = {c: check_kernels(fa, *shape, peaks, dev, lse_route=True)
            for c, shape in ring_shapes.items()}
    per_rank = {k: ring[True][k]["ms"] + (SP_RANKS - 1) * ring[False][k]["ms"]
                for k in ("fwd", "dq", "dkv", "split")}
    print("sp: causal ring layer per virtual rank, each kernel's time x its "
          "launches: " + ", ".join(f"{k} {t:.3f} ms"
                                   for k, t in per_rank.items()))

    kernels = [dict(name=f"flash_{k}", route="cuda",
                    source=SOURCE, replaces=REPLACES[k],
                    launches=counts[k], **flagship[k])
               for k in ("fwd", "dq", "dkv")]
    # The MoE flagship's attention is the flagship's: the same kernels at
    # the same shape, with their launches in the MoE run.
    kernels += [dict(name=f"flash_{k}_moe", route="cuda",
                     source=SOURCE, replaces=REPLACES[k],
                     launches=moe_counts[k], **flagship[k])
                for k in ("fwd", "dq", "dkv")]
    moe_attn = sum(flagship[k]["ms"] * moe_counts[k] / moe_steps
                   for k in ("fwd", "dq", "dkv"))
    print(f"moe: attention kernels {moe_attn:.2f} ms of the {moe_ms:.2f} ms "
          f"step (each kernel's flagship time x its launches per step)")
    # The pipelined flagship's kernels at its microbatch's shape, with
    # their launches in the pipelined run.
    kernels += [dict(name=f"flash_{k}_pp", route="cuda",
                     source=SOURCE, replaces=REPLACES[k],
                     launches=pp_counts[k], **mb[k])
                for k in ("fwd", "dq", "dkv")]
    # The elastic ranks' kernels at a rank's rows after the shrink (B 3),
    # with their launches in the elastic phase's steps (every rank's).
    kernels += [dict(name=f"flash_{k}_elastic", route="cuda",
                     source=SOURCE, replaces=REPLACES[k],
                     launches=el_counts[k], **el[k])
                for k in ("fwd", "dq", "dkv")]
    # The torch-api phase's kernels at an engine rank's rows (B 4), with
    # their launches in rank 0's training steps.
    kernels += [dict(name=f"flash_{k}_torch_api", route="cuda",
                     source=SOURCE, replaces=REPLACES[k],
                     launches=ta_counts[k], **ta[k])
                for k in ("fwd", "dq", "dkv")]
    # The ring hop's variants, with their launches in the causal ring run.
    for c, tag in ((True, "self"), (False, "hop")):
        for k in ("fwd", "dq", "dkv"):
            var = fa.variant(k, torch.bfloat16, torch.float32, c,
                             out_f32=(k == "fwd"))
            kernels.append(dict(
                name=f"flash_{k}_ring_{tag}", route="cuda",
                source=SOURCE, replaces=REPLACES[k],
                launches=sp_run["ring causal"][var], **ring[c][k]))
    # The split of each hop's fp32 dO, timed at the other hops' inputs.
    kernels.append(dict(name="flash_split_do", route="cuda",
                        source=SOURCE, replaces=REPLACES["split"],
                        launches=sp_run["ring causal"]["split"],
                        **ring[False]["split"]))
    # The fp32 kernels at the flagship's attention in fp32, with their
    # launches in the fp32 step: the forward, dQ and dK/dV on wgmma, and the
    # splits of q/k/v (per forward) and of dO (per backward).
    f32t = torch.float32
    for k in ("fwd", "dq", "dkv"):
        kernels.append(dict(
            name=f"flash_{k}_fp32", route="cuda",
            source=SOURCE, replaces=REPLACES[k],
            launches=f32_run[fa.variant(k, f32t, f32t, True)], **f32[k]))
    kernels.append(dict(name="flash_split_qkv_fp32", route="cuda",
                        source=SOURCE,
                        replaces=REPLACES["split_qkv"],
                        launches=f32_run["split qkv"], **f32["split_qkv"]))
    kernels.append(dict(name="flash_split_do_fp32", route="cuda",
                        source=SOURCE, replaces=REPLACES["split"],
                        launches=f32_run["split"], **f32["split"]))
    print(f"chip_smoke: total wall time "
          f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
