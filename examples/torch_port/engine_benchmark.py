"""Host data-plane microbenchmark on the port: ring throughput against
message size.  The twin of ``examples/engine_benchmark.py``.

The eager engine's analogue of the reference's NCCL bandwidth sweeps and
the surface its autotuner scores (bytes/s per sample window).  Two modes:

* **driver** (default, no ``HVD_SIZE`` in the environment): launches an
  N-rank gang per configuration, engine {native, py} × fusion {on, off},
  through the port's own function mode
  (``horovod_tpu_torch.runner.run.run``: rendezvous, HMAC secret and
  teardown come from the real launcher, and each rank's results return
  as values), then prints one ``RESULT {...}`` JSON line per cell and a
  markdown table;
* **worker** (``HVD_SIZE`` set, under ``hvdrun-torch``): times two
  workloads over the live gang:

  1. *bandwidth sweep*: one tensor per step, 64 KB to 64 MB, wire dtype
     {fp32, fp16 (bf16 on the wire), fp8 (e4m3)}; reports algorithm
     bandwidth (payload_bytes / wall) and ring bus bandwidth
     (2·(n−1)/n · payload / wall, the NCCL convention);
  2. *fusion sweep*: the same total payload as 64 equal async tensors
     synchronized together, which the controller fuses into large wire
     messages (``HVD_FUSION_THRESHOLD`` high) or ships as 64 rings (0).

The payloads are host arrays (the engine's data plane is the host's);
``--device`` is the device each rank's runtime is initialized on (default:
its card).  Run::

    python examples/torch_port/engine_benchmark.py --np 4
    python examples/torch_port/engine_benchmark.py --np 2 --quick \\
        --device cpu
    hvdrun-torch -np 4 --fusion-threshold-mb 64 -- \\
        python examples/torch_port/engine_benchmark.py
"""

import argparse
import json
import os
import sys
import time

import numpy as np

# Runnable straight from a checkout: put the repo root on sys.path.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def _wire_dtypes():
    from horovod_tpu_torch.ops.compression import Compression

    return [("fp32", Compression.none, np.float32),
            ("fp16", Compression.fp16, np.float32),
            ("fp8", Compression.fp8, np.float32)]


def bench_workloads(quick: bool, device=None):
    """Runs on every rank of a live gang; returns the result rows (rank
    0's copy is authoritative: every rank measures the same collectives)."""
    import horovod_tpu_torch as hvd

    hvd.init(device=device, backend="none")  # a no-op under run()
    rank, n = hvd.rank(), hvd.size()
    sizes = ([1 << 16, 1 << 20] if quick
             else [1 << 16, 1 << 18, 1 << 20, 1 << 23, 1 << 26])
    results = []

    def timed(fn, payload_bytes, iters):
        fn()  # warm the path (socket buffers, name negotiation)
        hvd.barrier()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        dt = (time.perf_counter() - t0) / iters
        alg = payload_bytes / dt
        bus = 2.0 * (n - 1) / n * payload_bytes / dt
        return alg / 1e6, bus / 1e6, dt * 1e3

    # 1. bandwidth sweep: one tensor per step
    for label, comp, dt_ in _wire_dtypes():
        for size in sizes:
            count = size // np.dtype(dt_).itemsize
            x = np.random.RandomState(rank).randn(count).astype(dt_)
            iters = max(2, min(30, (1 << 24) // size))
            name = f"bw.{label}.{size}"

            def one():
                hvd.allreduce(x, op=hvd.Sum, name=name, compression=comp)

            alg, bus, ms = timed(one, size, iters)
            results.append(dict(mode="single", wire=label, bytes=size,
                                alg_mb_s=round(alg, 1),
                                bus_mb_s=round(bus, 1),
                                ms_per_op=round(ms, 3)))

    # 2. fusion sweep: 64 equal tensors submitted async, synced together
    for size in sizes:
        k = 64
        count = max(1, size // k // 4)
        xs = [np.random.RandomState(rank + i).randn(count)
              .astype(np.float32) for i in range(k)]
        payload = count * 4 * k
        iters = max(2, min(20, (1 << 23) // max(payload, 1)))
        base = f"fuse.{size}"

        def grouped():
            hs = [hvd.allreduce_async(xs[i], op=hvd.Sum,
                                      name=f"{base}.{i}")
                  for i in range(k)]
            for h in hs:
                hvd.synchronize(h)

        alg, bus, ms = timed(grouped, payload, iters)
        results.append(dict(mode="grouped64", wire="fp32", bytes=payload,
                            alg_mb_s=round(alg, 1),
                            bus_mb_s=round(bus, 1),
                            ms_per_op=round(ms, 3)))
    return results


def worker(args) -> None:
    import horovod_tpu_torch as hvd

    rows = bench_workloads(args.quick, args.device)
    if hvd.rank() == 0:
        for r in rows:
            print("BENCH " + json.dumps(r), flush=True)
    hvd.shutdown()


def driver(args) -> None:
    # The gangs go through the port's own function mode: one launch path,
    # with rendezvous, job secret, environment and teardown handled by
    # the real launcher.
    from horovod_tpu_torch.runner.run import run as hvd_run

    engines = ["native", "py"] if not args.engine else [args.engine]
    cells = []
    for engine in engines:
        for fusion_mb in (64, 0):
            env = {"HVD_FUSION_THRESHOLD": str(fusion_mb << 20),
                   "HVD_TPU_CORE": "py" if engine == "py" else ""}
            print(f"--- engine={engine} fusion={fusion_mb}MB "
                  f"np={args.np} ---", flush=True)
            per_rank = hvd_run(bench_workloads, (args.quick,),
                               np=args.np, env=env, device=args.device)
            for r in per_rank[0]:
                r.update(engine=engine, fusion_mb=fusion_mb, np=args.np)
                cells.append(r)
                print("RESULT " + json.dumps(r), flush=True)

    # Markdown summary: fusion's effect on the 64-tensor workload.
    print("\n| engine | payload | fused 64MB thr (MB/s) | "
          "unfused (MB/s) | speedup |")
    print("|---|---|---|---|---|")
    by_key = {(c["engine"], c["fusion_mb"], c["bytes"]): c
              for c in cells if c["mode"] == "grouped64"}
    for (engine, fusion_mb, size), c in sorted(by_key.items()):
        if fusion_mb == 0:
            continue
        off = by_key.get((engine, 0, size))
        if off:
            sp = c["alg_mb_s"] / max(off["alg_mb_s"], 1e-9)
            print(f"| {engine} | {size >> 10} KB | {c['alg_mb_s']} | "
                  f"{off['alg_mb_s']} | {sp:.2f}x |")


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--np", type=int, default=2)
    p.add_argument("--quick", action="store_true")
    p.add_argument("--engine", choices=["native", "py"])
    p.add_argument("--device", default=None,
                   help="each rank's device (default: its card)")
    args = p.parse_args()
    if os.environ.get("HVD_SIZE"):
        worker(args)
    else:
        driver(args)


if __name__ == "__main__":
    main()
