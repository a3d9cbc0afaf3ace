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
   16, D 64, bf16, causal), and at head dims 96 and 256 (B 2, S 1000, H 8,
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
   times, the KV cache's bytes and the peak memory.  Serving runs no
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
   link media;
7. the engine's data plane: four ranks of this script
   (``--dataplane-rank R``) on cuda:0 as two virtual nodes of two, with
   the hierarchical allreduce and allgather, the recovery ladder and the
   timeline on, node 1 under ``HVD_SHM_DISABLE`` (see DP_RANKS): seeded
   card tensors at the flagship's widths through allreduce, a ragged
   allgather and broadcasts, against every rank's inputs rebuilt from the
   seeds, then again under fault plans with the first pass's bits; rank
   0's timeline parsed and checked.  Prints the media, each pass's time
   and GB/s and the ladder's retries and failovers;
8. the kernel checks of phase 2 again, and the times of the kernel, the
   plain version and PyTorch's ``scaled_dot_product_attention`` as a
   yardstick (forward alone for the forward, backward alone for dQ and
   dK/dV; the port never calls it), each as its kernels' device time per
   call under ``torch.profiler``, and the kernel also between CUDA events,
   which counts the host's gaps.  This comes after the slice, so that the
   steps are timed before any profiler has run.

The ``kernels`` JSON lists the flagship's three kernels, the same three
with their launches in the MoE flagship's run (``flash_<kernel>_moe``: its
attention is the flagship's), the same three at the pipelined flagship's
microbatch (B 2, S 1024, H 16, D 64, bf16, causal; checked in phase 2)
with their launches in its run (``flash_<kernel>_pp``), the ring hop's six
variants
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
        ms, plain_ms = _device_ms(kern), _device_ms(plain)
        lib_ms = None if lib is None else _device_ms(lib)
        event_ms = _time_ms(kern)
        # Where the profiler saw no device time, the events' time stands
        # in (it counts the host's gaps as well).
        timed_by = "events" if ms is None else "device"
        ms = event_ms if ms is None else ms
        plain_ms = _time_ms(plain) if plain_ms is None else plain_ms
        if lib is not None and lib_ms is None:
            lib_ms = _time_ms(lib)
        bound_ms, bound_by = _bound(kname, B, S, H, D, dtype, causal,
                                    with_dlse, peaks, lse_route)
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
    bad = []
    for i, ((p, m), r) in enumerate(zip(reqs, replies)):
        if r is None or r[0] != 200 or len(r[1].get("tokens", ())) != m:
            bad.append(f"request {i}: reply {r and r[0]} "
                       f"{str(r and r[1])[:120]}")
    _fail_if(bad, "serve")

    # The tokens against generate() on each prompt alone.
    t_or = time.perf_counter()
    for i, (p, m) in enumerate(reqs):
        want = tfm.generate(model, [p], max_new_tokens=m,
                            cache_len=SERVE_CACHE)[0, len(p):].tolist()
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
          f"{np.percentile(ttft, 99):.2f} ms; {card}")
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


def _spawn_ranks(flag, n, tmp, env_of, timeout, what):
    """Run ``n`` ranks of this script (``flag R tmp``) against the port's
    ``RendezvousServer``; returns each rank's (exit code, output), killing
    every rank past ``timeout``."""
    from horovod_tpu_torch.runner.http_server import RendezvousServer

    server = RendezvousServer("127.0.0.1")
    port = server.start()
    base = {k: v for k, v in os.environ.items()
            if not k.startswith(("HVD_", "MASTER_", "HOROVOD_"))}
    procs, outs = [], []
    try:
        for r in range(n):
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), flag, str(r),
                 tmp],
                env=dict(base, HVD_RENDEZVOUS_ADDR="127.0.0.1",
                         HVD_RENDEZVOUS_PORT=str(port), **env_of(r)),
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        deadline = time.monotonic() + timeout
        for p in procs:
            try:
                out, _ = p.communicate(
                    timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                out, _ = p.communicate()
                out += f"\n(killed after {timeout} s)"
            outs.append((p.returncode, out))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        server.stop()
    for r, (code, out) in enumerate(outs):
        for line in out.splitlines():
            print(f"{what} rank {r}: {line}")
    failed = [r for r, (code, _) in enumerate(outs) if code != 0]
    if failed:
        raise AssertionError(f"{what}: rank(s) {failed} failed")
    return outs


def run_engine(hvd, tfm, fa, dev, card, cfg=None, timeout=ENGINE_TIMEOUT_S):
    """The eager engine on the card: ENGINE_RANKS ranks of this script
    (``--engine-rank R``) bootstrap a ``PyEngine`` through the port's
    ``RendezvousServer`` and train the flagship (``cfg``: by default the
    full-width flagship) for ENGINE_STEPS steps, each rank on its rows of
    the batch, the gradients averaged by one ``allreduce_async`` per
    parameter; held against ``make_transformer_train_step`` in this process
    on all the rows, from the same weights."""
    import tempfile

    import torch

    cfg = cfg or _flagship_cfg(tfm)
    B = 8
    batches = _token_batches(dev, ENGINE_STEPS, B=B, S=cfg.max_seq_len,
                             vocab=cfg.vocab_size, seed=7)
    # The one-process step on all the rows, from seed 0's weights.
    hvd.init(device=dev)
    try:
        step_fn, init_fn = hvd.make_transformer_train_step(cfg, device=dev)
        state = init_fn(0)
        for s, (tokens, targets) in enumerate(batches):
            state, loss = step_fn(state, tokens, targets)
            if s == 0:
                ref_loss = float(loss)
                ref_grads = {n: p.grad.detach().clone()
                             for n, p in state.model.named_parameters()}
        ref_params = {n: p.detach().clone()
                      for n, p in state.model.named_parameters()}
        del state, step_fn, init_fn
    finally:
        hvd.shutdown()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        fields = {f.name: getattr(cfg, f.name)
                  for f in dataclasses.fields(cfg)}
        fields["compute_dtype"] = str(cfg.compute_dtype).split(".")[1]
        with open(os.path.join(tmp, "config.json"), "w") as fh:
            json.dump({"cfg": fields, "device": str(dev), "rows": B,
                       "steps": ENGINE_STEPS, "store_port": _free_port()},
                      fh)
        t0 = time.perf_counter()
        _spawn_ranks("--engine-rank", ENGINE_RANKS, tmp, lambda r: dict(
            HVD_RANK=str(r), HVD_SIZE=str(ENGINE_RANKS),
            HVD_LOCAL_RANK=str(r), HVD_LOCAL_SIZE=str(ENGINE_RANKS)),
            timeout, "engine")
        wall = time.perf_counter() - t0
        ranks = []
        for r in range(ENGINE_RANKS):
            with open(os.path.join(tmp, f"rank{r}.json")) as fh:
                ranks.append(json.load(fh))
        got = torch.load(os.path.join(tmp, "rank0.pt"))

    failures = []
    loss_gap = abs(ranks[0]["loss0_mean"] - ref_loss)
    grad_gaps = {n: float((got["grads0"][n].to(dev) - g).norm()
                          / g.norm().clamp_min(1e-30))
                 for n, g in ref_grads.items()}
    param_gaps = {n: float((got["params"][n].to(dev) - p).norm()
                           / p.norm().clamp_min(1e-30))
                  for n, p in ref_params.items()}
    wg = max(grad_gaps, key=grad_gaps.get)
    wp = max(param_gaps, key=param_gaps.get)
    print(f"engine: {ENGINE_RANKS} ranks on {dev} through the port's "
          f"RendezvousServer and PyEngine, {wall:.1f} s wall; step-0 loss "
          f"(the ranks' mean) {ranks[0]['loss0_mean']!r} against one "
          f"process on all {B} rows {ref_loss!r}: gap {loss_gap:.3e} (tol "
          f"{ENGINE_LOSS_TOL}); largest |g - g_one| / |g_one| of the "
          f"averaged step-0 gradients {grad_gaps[wg]:.3e} ({wg}; tol "
          f"{ENGINE_GRAD_TOL}); largest |p - p_one| / |p_one| after "
          f"{ENGINE_STEPS} steps {param_gaps[wp]:.3e} ({wp}; tol "
          f"{ENGINE_PARAM_TOL})")
    if not loss_gap <= ENGINE_LOSS_TOL:
        failures.append("the step-0 loss")
    if not grad_gaps[wg] <= ENGINE_GRAD_TOL:
        failures.append("the averaged step-0 gradients")
    if not param_gaps[wp] <= ENGINE_PARAM_TOL:
        failures.append(f"the parameters after {ENGINE_STEPS} steps")
    want_launches = {"fwd": 2 * cfg.n_layers * ENGINE_STEPS,
                     "dq": cfg.n_layers * ENGINE_STEPS,
                     "dkv": cfg.n_layers * ENGINE_STEPS, "split": 0}
    for r, res in enumerate(ranks):
        steps = res["steps"]
        gbs = [round(s["grad_bytes"] / (s["enqueue_ms"] + s["sync_ms"])
                     / 1e6, 3) for s in steps]
        print(f"engine rank {r}: step ms "
              f"{[round(s['ms'], 1) for s in steps]}, median "
              f"{statistics.median(s['ms'] for s in steps):.1f}; enqueue "
              f"(the gradients' copies to the host) ms "
              f"{[round(s['enqueue_ms'], 1) for s in steps]}; in "
              f"synchronize ms {[round(s['sync_ms'], 1) for s in steps]}; "
              f"gradient bytes a step {steps[0]['grad_bytes']}; fused "
              f"responses {[s['responses'] for s in steps]} (the 64 MiB "
              f"threshold's grouping of all {res['n_params']} tensors at "
              f"once: {res['greedy_groups']}), largest "
              f"{max(s['largest_response'] for s in steps)} bytes; "
              f"effective GB/s (gradient bytes / time in enqueue and "
              f"synchronize) {gbs}; "
              f"cache hits {[s['cache']['hits'] for s in steps]}, misses "
              f"{[s['cache']['misses'] for s in steps]}; flash launches "
              f"{res['launches']}")
        if not res["bcast_bits_equal"]:
            failures.append(f"rank {r}: broadcast_parameters' weights are "
                            "not rank 0's bit for bit")
        if not res["params_equal_across_ranks"]:
            failures.append(f"rank {r}: the ranks' parameters differ "
                            f"after {ENGINE_STEPS} steps")
        if not res["card_tensors_equal"]:
            failures.append(f"rank {r}: card tensors through the engine "
                            f"differ from their CPU copies: "
                            f"{res['card_tensors']}")
        hits = [s["cache"]["hits"] for s in steps]
        misses = [s["cache"]["misses"] for s in steps]
        n = res["n_params"]
        if hits != [0] + [n] * (ENGINE_STEPS - 1) or \
                misses != [n] + [0] * (ENGINE_STEPS - 1):
            failures.append(f"rank {r}: cache hits {hits} and misses "
                            f"{misses}, not every tensor cached after "
                            "step 0")
        for s in steps:
            if s["fused_tensors"] != n or \
                    s["responses"] < res["greedy_groups"] or \
                    not s["within_threshold"]:
                failures.append(f"rank {r}: step {s['step']}'s fused "
                                "responses break the 64 MiB grouping")
        if dev.type == "cuda" and res["launches"] != want_launches:
            failures.append(f"rank {r}: flash launches {res['launches']} "
                            f"!= {want_launches}")
        if not all(math.isfinite(s["loss"]) for s in steps):
            failures.append(f"rank {r}: a loss is not finite")
        print(f"engine rank {r}: link media by peer {res['media']}")
        if set(res["media"].values()) != {"shm"}:
            failures.append(f"rank {r}: a same-host pair is not on the "
                            f"shm ring: {res['media']}")
    print(f"engine: on {card}; {ranks[0]['bcast_ms']:.1f} ms to broadcast "
          f"the parameters ({ranks[0]['param_bytes']} bytes) from rank 0")
    if failures:
        raise AssertionError("engine: " + "; ".join(failures))
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
        greedy = _greedy_groups(sizes, eng.fusion_threshold)
        eng.response_log = []
        steps, grads0 = [], None
        fa.reset_launch_counts()
        for s, (tokens, targets) in enumerate(batches):
            before = hvd.cache_stats()
            _sync_dev(torch, dev)
            t0 = time.perf_counter()
            opt.zero_grad(set_to_none=True)
            loss = tfm.loss_fn(model, tokens[rows], targets[rows])
            loss.backward()
            mark = len(eng.response_log)
            t1 = time.perf_counter()
            handles = [hvd.allreduce_async(p.grad, name=n, op=hvd.Average)
                       for n, p in model.named_parameters()]
            t2 = time.perf_counter()
            for (n, p), h in zip(model.named_parameters(), handles):
                p.grad = hvd.synchronize(h)
            t3 = time.perf_counter()
            if s == 0:
                grads0 = {n: p.grad.detach().to("cpu", copy=True)
                          for n, p in model.named_parameters()}
            opt.step()
            _sync_dev(torch, dev)
            t4 = time.perf_counter()
            log = [e for e in eng.response_log[mark:]
                   if e[0] == "ALLREDUCE"]
            after = hvd.cache_stats()
            steps.append(dict(
                step=s, loss=float(loss.detach()), ms=(t4 - t0) * 1e3,
                backward_ms=(t1 - t0) * 1e3, enqueue_ms=(t2 - t1) * 1e3,
                sync_ms=(t3 - t2) * 1e3, grad_bytes=sum(sizes),
                responses=len(log), fused_tensors=sum(e[1] for e in log),
                largest_response=max(e[2] for e in log),
                within_threshold=all(e[1] == 1 or
                                     e[2] <= eng.fusion_threshold
                                     for e in log),
                cache={k: after[k] - before[k] for k in ("hits",
                                                         "misses")}))
        launches = dict(fa.launches)
        eng.response_log = None
        media = eng.transport_media()
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
            media={str(p): m for p, m in media.items()})
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

    t0 = time.perf_counter()
    _build.lib()
    print(f"build: {time.perf_counter() - t0:.1f} s -> {_build.library_path()}")
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
    for shape in shapes + (f32_flagship, micro, engine_rows) + dim_shapes:
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
    run_serve(tfm, dev, card)
    torch.cuda.empty_cache()
    run_engine(hvd, tfm, fa, dev, card)
    torch.cuda.empty_cache()
    run_dataplane(tfm, dev, card)
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
