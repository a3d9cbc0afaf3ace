#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``horovod_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which must pass (nothing is caught; any failure exits
non-zero):

0. the card (``nvidia-smi``), torch and nvcc versions;
1. build the CUDA kernels from ``horovod_tpu_torch/ops/csrc`` with nvcc;
2. hold each kernel (flash forward, dQ, dK/dV) against its plain PyTorch
   version, computed in fp32 on the card, at the flagship shape (B 8, S 1024,
   H 16, D 64, bf16, causal) and at a ragged one (S 1000, D 32, fp32,
   non-causal, nonzero dlse); time the kernel, the plain version and
   PyTorch's ``scaled_dot_product_attention`` as a yardstick (the port never
   calls it);
3. the slice: ``hvd.init()`` (a one-rank NCCL group), the flagship
   transformer at full width and depth (vocab 32768, d_model 1024, 8 layers,
   16 heads, d_ff 4096, seq 1024, batch 8, bf16, flash attention, remat)
   with weights from a fixed seed, five training steps through
   ``make_transformer_train_step`` (``DistributedOptimizer`` over AdamW).
   A twin with dense attention starts from the same weights and takes
   the same steps.  Checks: finite losses, 16 forward, 8 dQ and 8 dK/dV
   launches per step, the first step's gradients and every step's loss
   against the twin's.

The last three lines are the ``kernels`` JSON, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.  Exits non-zero, printing no
result, where torch finds no CUDA device.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

# Peak rates for the bound: (bf16 dense tensor-core FLOP/s, fp32 FLOP/s
# outside the tensor cores, device-memory bytes/s), from NVIDIA's "H100
# Tensor Core GPU" data sheet (dense rates, without sparsity, at the full
# power limit), keyed by a part of the name the driver reports.  A card
# that matches no key stops the run rather than borrow another's peaks.
PEAKS = {
    "H100 80GB HBM3": (989e12, 67e12, 3.35e12),  # SXM5
    "H100 SXM": (989e12, 67e12, 3.35e12),
    "H100 PCIe": (756e12, 51e12, 2.0e12),
    "H100 NVL": (835e12, 60e12, 3.9e12),
}
SOURCE = "horovod_tpu_torch/ops/csrc/flash_attention.cu"
REPLACES = {"fwd": "horovod_tpu/ops/pallas_attention.py:77",
            "dq": "horovod_tpu/ops/pallas_attention.py:174",
            "dkv": "horovod_tpu/ops/pallas_attention.py:215"}
# Each element of a kernel output against its plain version in fp32:
# |got - want| <= rtol |want| + atol rms(want), as (rtol, atol), by the
# output's dtype.  bf16: rtol is two bf16 ulps (2^-7), as the kernel rounds
# its fp32 result once (at most half an ulp); fp32: summation order only.
TOL = {"bfloat16": (2.0 ** -7, 1e-3), "float32": (1e-4, 1e-4)}
# The slice against its dense-attention twin (same weights, same steps).
# Step 0's loss is forward only; the gradients of step 0 (|g_flash -
# g_dense| / |g_dense| for each parameter) go through the dQ and dK/dV
# kernels, and so do the weights of every later step.  Each tolerance is
# about twice the gap measured on an H100 (2.2e-5, 2.6e-2, 5.6e-3; the dense
# twin rounds its logits, probabilities and dP to bf16, flash keeps them in
# fp32) and below what each planted fault read, a dropped tile or a shifted
# causal diagonal, some only just (PERF.md): the kernel checks above are
# the guard, this is the backstop.
LOSS_TOL = 1e-4
GRAD_TOL = 5e-2
STEP_LOSS_TOL = 1e-2


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


def _time_ms(fn, reps=20, warmup=3):
    """Median of ``reps`` CUDA-event timings of ``fn`` after ``warmup``."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _bound(kernel, B, S, H, D, dtype, causal, has_dlse, peaks):
    """Least time for the kernel's work: max(FLOPs / peak, bytes / rate),
    counting each input read once and each output written once, and only
    the query-key pairs the causal mask leaves."""
    import torch

    pairs = B * H * (S * (S + 1) // 2 if causal else S * S)
    flops = {"fwd": 4, "dq": 6, "dkv": 8}[kernel] * D * pairs
    e = torch.empty((), dtype=dtype).element_size()
    n = B * S * H * D
    stats = 4 * B * S * H
    nbytes = {"fwd": 4 * n * e + stats,
              "dq": 5 * n * e + stats * (2 + has_dlse),
              "dkv": 6 * n * e + stats * (2 + has_dlse)}[kernel]
    bf16, f32, bw = peaks
    t_ops = flops / (bf16 if dtype == torch.bfloat16 else f32)
    t_bytes = nbytes / bw
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def _check(name, got, want, failures):
    """Each element within TOL of the plain version (see TOL).  Prints the
    worst element's share of its tolerance (at most 1 passes), the relative
    error norm, and the max error over max |want|; returns the max abs
    error and appends to ``failures`` on a mismatch."""
    rtol, atol = TOL[str(got.dtype).split(".")[1]]
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    allowed = rtol * want.abs() + atol * float(want.pow(2).mean().sqrt())
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


def check_kernels(fa, B, S, H, D, dtype, causal, with_dlse, peaks, dev):
    """Each kernel against its plain version in fp32 on the same inputs;
    returns {kernel: measurements}."""
    import torch
    import torch.nn.functional as F

    dname = str(dtype).split(".")[1]
    print(f"kernels at B {B} S {S} H {H} D {D} {dname} "
          f"{'causal' if causal else 'non-causal'}"
          f"{' dlse' if with_dlse else ''}:")
    gen = torch.Generator(device=dev).manual_seed(S * 131 + D)
    q, k, v, do = (torch.randn(B, S, H, D, device=dev, generator=gen)
                   .to(dtype) for _ in range(4))
    scale = 1.0 / math.sqrt(D)
    f32 = [t.float() for t in (q, k, v, do)]
    po, plse = fa._flash_fwd_plain(*f32[:3], scale, causal)
    dlse = (torch.randn(B, S, H, device=dev, generator=gen)
            if with_dlse else None)
    delta = (f32[3] * po).sum(-1)
    bargs = (q, k, v, do, plse, delta, dlse, scale, causal)
    pargs = tuple(f32) + (plse, delta, dlse, scale, causal)

    o, lse = fa.flash_fwd_cuda(q, k, v, scale, causal)
    dq = fa.flash_dq_cuda(*bargs)
    dk, dv = fa.flash_dkv_cuda(*bargs)
    torch.cuda.synchronize()
    pdq = fa._flash_dq_plain(*pargs)
    pdk, pdv = fa._flash_dkv_plain(*pargs)
    bad = []
    err = {"fwd": max(_check("fwd o", o, po, bad),
                      _check("fwd lse", lse, plse, bad)),
           "dq": _check("dq", dq, pdq, bad),
           "dkv": max(_check("dk", dk, pdk, bad), _check("dv", dv, pdv, bad))}
    _fail_if(bad, f"kernels at S {S} D {D} {dname}")

    qh, kh, vh, doh = (t.transpose(1, 2).contiguous() for t in (q, k, v, do))
    qg, kg, vg = (t.detach().requires_grad_() for t in (qh, kh, vh))

    def sdpa_fwd_bwd():
        out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal)
        torch.autograd.grad(out, (qg, kg, vg), doh)

    timing = {
        "fwd": (lambda: fa.flash_fwd_cuda(q, k, v, scale, causal),
                lambda: fa._flash_fwd_plain(q, k, v, scale, causal),
                lambda: F.scaled_dot_product_attention(qh, kh, vh,
                                                       is_causal=causal)),
        "dq": (lambda: fa.flash_dq_cuda(*bargs),
               lambda: fa._flash_dq_plain(*bargs), sdpa_fwd_bwd),
        "dkv": (lambda: fa.flash_dkv_cuda(*bargs),
                lambda: fa._flash_dkv_plain(*bargs), sdpa_fwd_bwd),
    }
    out = {}
    for kname, (kern, plain, lib) in timing.items():
        ms, plain_ms, lib_ms = _time_ms(kern), _time_ms(plain), _time_ms(lib)
        bound_ms, bound_by = _bound(kname, B, S, H, D, dtype, causal,
                                    with_dlse, peaks)
        print(f"  {kname}: kernel {ms:.3f} ms  plain {plain_ms:.3f} ms  "
              f"sdpa{'' if kname == 'fwd' else ' fwd+bwd'} {lib_ms:.3f} ms  "
              f"bound {bound_ms:.4f} ms ({bound_by})")
        out[kname] = dict(max_abs_err=err[kname], ms=ms, plain_ms=plain_ms,
                          bound_ms=bound_ms, bound_by=bound_by,
                          library_ms=lib_ms)
    return out


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


def run_slice(hvd, tfm, fa, dev, card):
    """Five flagship training steps, each followed by the same step of a
    dense-attention twin made from the same seed; returns (launch counts,
    median step ms, steps)."""
    import dataclasses

    import torch

    cfg = tfm.TransformerConfig(
        vocab_size=32768, d_model=1024, n_layers=8, n_heads=16, d_ff=4096,
        max_seq_len=1024, compute_dtype=torch.bfloat16, attn_impl="flash",
        remat=True)
    B, S, steps = 8, 1024, 5
    step_fn, init_fn = hvd.make_transformer_train_step(cfg)
    twin_step, twin_init = hvd.make_transformer_train_step(
        dataclasses.replace(cfg, attn_impl="dense"))
    state, twin = init_fn(0), twin_init(0)
    gen = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), device=dev,
                           generator=gen)
    targets = torch.roll(tokens, -1, dims=1)
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

    bad = []
    print(f"slice: flash losses {losses}")
    print(f"slice: dense twin losses {twin_losses}")
    diffs = [abs(a - b) for a, b in zip(losses, twin_losses)]
    print(f"slice: |flash - dense| per step {[f'{d:.3e}' for d in diffs]} "
          f"(tol {LOSS_TOL} at step 0, {STEP_LOSS_TOL} after)")
    print("slice: step-0 gradient gap to the dense twin, largest over "
          "layers: " + ", ".join(f"{k} {v:.2e}" for k, v in gaps.items())
          + f" (tol {GRAD_TOL})")
    if not all(math.isfinite(x) for x in losses):
        bad.append(f"non-finite loss: {losses}")
    if diffs[0] > LOSS_TOL:
        bad.append("step-0 loss disagrees with dense")
    if max(diffs[1:]) > STEP_LOSS_TOL:
        bad.append("a later step's loss disagrees with dense")
    if max(gaps.values()) > GRAD_TOL:
        bad.append("step-0 gradients disagree with dense")
    want = {"fwd": 16 * steps, "dq": 8 * steps, "dkv": 8 * steps}
    print(f"slice: kernel launches over {steps} steps {counts} "
          f"(want {want})")
    if counts != want:
        bad.append(f"launch counts {counts} != {want}")
    _fail_if(bad, "slice")
    step_ms = statistics.median(times)
    print(f"slice: step times ms {times}")
    print(f"slice: median step {step_ms:.2f} ms, "
          f"{B * S / step_ms * 1e3:.0f} tokens/s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB (with the "
          f"twin) on {card}")
    return counts, step_ms, steps


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import transformer as tfm
    from horovod_tpu_torch.ops import _build
    from horovod_tpu_torch.ops import flash_attention as fa

    card = _sh(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"]).splitlines()[0]
    nvcc = "; ".join(_sh([_build._nvcc(), "--version"]).splitlines()[-2:])
    print(f"card: {card} | torch {torch.__version__} "
          f"(CUDA {torch.version.cuda}) | nvcc: {nvcc}")
    peak_name, peaks = _peaks(torch.cuda.get_device_name(0))
    print(f"peaks ({peak_name}): bf16 {peaks[0] / 1e12:g} TFLOP/s, fp32 "
          f"{peaks[1] / 1e12:g} TFLOP/s, {peaks[2] / 1e12:g} TB/s")

    t0 = time.perf_counter()
    _build.lib()
    print(f"build: {time.perf_counter() - t0:.1f} s -> {_build.library_path()}")
    if _build.build_log:
        spills = [ln for ln in _build.build_log.splitlines()
                  if "spill" in ln and not ln.strip().startswith("0 bytes")]
        print(f"build: {len(spills)} kernels with register spills")
    else:
        print("build: library built earlier; no ptxas report")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    flagship = check_kernels(fa, 8, 1024, 16, 64, torch.bfloat16, True,
                             False, peaks, dev)
    check_kernels(fa, 2, 1000, 8, 32, torch.float32, False, True, peaks, dev)

    hvd.init()
    try:
        counts, step_ms, steps = run_slice(hvd, tfm, fa, dev, card)
    finally:
        hvd.shutdown()
    attn_ms = sum(flagship[k]["ms"] * counts[k] / steps for k in counts)
    print(f"slice: attention kernels {attn_ms:.2f} ms of the {step_ms:.2f} ms "
          f"step (each kernel's flagship time x its launches per step)")

    kernels = [dict(name=f"flash_{k}", route="cuda", source=SOURCE,
                    replaces=REPLACES[k], launches=counts[k], **flagship[k])
               for k in ("fwd", "dq", "dkv")]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
