#!/usr/bin/env python3
"""How the order of the fp32 dQ's plane-pair products moves its error.

    python3 tools/torch_dq_order.py

Needs one NVIDIA card.  The fp32 dQ (``dq_wgmma_kernel<D, true, true>`` in
``horovod_tpu_torch/ops/csrc/flash_wgmma.cu``) runs each of its three
products as six bf16 wgmmas over plane pairs, summed in the tensor cores'
fp32 accumulators.  For each order below, the script copies
``horovod_tpu_torch/`` and ``chip_smoke.py`` into a fresh temporary
directory, edits the dQ kernel there (the checkout is never touched),
builds that copy and prints the fp32 dQ instantiations' registers and
spills, and at ``chip_smoke.py``'s fp32 shapes (B 2, S 1000, H 8, D 32,
non-causal, dlse, with the inputs of both of its checks there, and the
flagship's attention, B 8, S 1024, H 16, D 64, causal) and at widths 16,
128 and 256 (B 2, S 1000, H 8) the worst element of dQ as a share of
``chip_smoke.TOL["float32"]`` against ``_flash_dq_plain`` and the kernel's
device time per call (planes split beforehand, as the backward passes
them).  The orders:

* ``small first``: the kernel as it is: each product's pairs smallest
  first, hi.hi last (``dq_pair``);
* ``hi.hi first``: the pairs in ``pair_a``/``pair_b`` order;
* ``two-level``: hi.hi first, and each key tile's six dS.K products in a
  fresh accumulator added into the running dQ in registers (DP/2 more
  registers);
* ``two-level, small first``: both.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join("horovod_tpu_torch", "ops", "csrc", "flash_wgmma.cu")
# The dQ kernel's text in the source: edits apply between these.
START = "dq_wgmma_kernel(const __grid_constant__ Maps maps,"
END = "// The bf16 planes of fp32 tensors"

HI_FIRST = [("const int pr = dq_pair(i);", "const int pr = i;")]
TWO_LEVEL = [
    ("""      for (int kk = 0; kk < BK / 16; ++kk) a_frag_split3(dp, kk, df[kk]);
      wg_fence();""",
     """      for (int kk = 0; kk < BK / 16; ++kk) a_frag_split3(dp, kk, df[kk]);
      float part[DP / 2];
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) part[i] = 0.f;
      wg_fence();"""),
    ("""          mma_rs<DP, DP>(dqacc, df[kk][pair_a(pr)],
                         Kt + pair_b(pr) * L::bytes(BK), BK, kk, 0);
      }
    } else {""",
     """          mma_rs<DP, DP>(part, df[kk][pair_a(pr)],
                         Kt + pair_b(pr) * L::bytes(BK), BK, kk, 0);
      }
      wg_commit();
      wg_wait();
      reg_fence(part);
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) dqacc[i] += part[i];
    } else {""")]
ORDERS = {"small first": [], "hi.hi first": HI_FIRST,
          "two-level": HI_FIRST + TWO_LEVEL,
          "two-level, small first": TWO_LEVEL}

RUN = """
import math, re, sys, torch
sys.path.insert(0, {root!r})
import chip_smoke
from horovod_tpu_torch.ops import _build
from horovod_tpu_torch.ops import flash_attention as fa

_build.lib()
name = None
for line in _build.build_log.splitlines():
    if "Function properties for " in line:
        name = line.split("Function properties for ", 1)[1].strip()
    m = re.search(r"dq_wgmma_kernelILi(\\d+)ELb1ELb1E", name or "")
    if m and ("spill" in line or "Used " in line):
        print(f"  width {{m.group(1)}}: {{line.split(':', 1)[-1].strip()}}")
torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda", 0)
rtol, atol = chip_smoke.TOL["float32"]
# (B, S, H, D, causal, with dlse, seed as chip_smoke.check_kernels draws)
for B, S, H, D, causal, dlse, seed in (
        (2, 1000, 8, 32, False, True, 1000 * 131 + 32),
        (2, 1000, 8, 32, False, True, 1000 * 131 + 33),
        (8, 1024, 16, 64, True, False, 1024 * 131 + 64),
        (2, 1000, 8, 16, True, True, 1000 * 131 + 16),
        (2, 1000, 8, 128, True, True, 1000 * 131 + 128),
        (2, 1000, 8, 256, False, True, 1000 * 131 + 256)):
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, do = (torch.randn(B, S, H, D, device=dev, generator=gen)
                   for _ in range(4))
    scale = 1.0 / math.sqrt(D)
    po, plse = fa._flash_fwd_plain(q, k, v, scale, causal)
    dl = torch.randn(B, S, H, device=dev, generator=gen) if dlse else None
    args = (q, k, v, do, plse, (do * po).sum(-1), dl, scale, causal)
    planes, dop = fa.split_qkv_cuda(q, k, v), fa.split_do_cuda(do, 3)
    got = fa.flash_dq_cuda(*args, do_planes=dop, qkv_planes=planes).double()
    want = fa._flash_dq_plain(*args).double()
    allowed = rtol * want.abs() + atol * float(want.pow(2).mean().sqrt())
    worst = float(((got - want).abs() / allowed).max())
    ms = chip_smoke._device_ms(
        lambda: fa.flash_dq_cuda(*args, do_planes=dop, qkv_planes=planes))
    print(f"  B {{B}} S {{S}} H {{H}} D {{D}} {{'causal' if causal else 'non-causal'}}"
          f"{{' dlse' if dlse else ''}} (seed {{seed}}): dq worst element "
          f"{{worst:.3f}} of TOL, device {{ms:.4f}} ms", flush=True)
"""


def run(name, edits):
    with tempfile.TemporaryDirectory() as root:
        shutil.copytree(os.path.join(REPO, "horovod_tpu_torch"),
                        os.path.join(root, "horovod_tpu_torch"),
                        ignore=shutil.ignore_patterns("__pycache__"))
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), root)
        path = os.path.join(root, SRC)
        with open(path) as f:
            text = f.read()
        a, b = text.index(START), text.index(END)
        body = text[a:b]
        for find, repl in edits:
            if find not in body:
                raise RuntimeError(f"{name}: text to replace not found")
            body = body.replace(find, repl)
        with open(path, "w") as f:
            f.write(text[:a] + body + text[b:])
        print(f"order: {name}", flush=True)
        return subprocess.run([sys.executable, "-c", RUN.format(root=root)],
                              cwd=root).returncode


def main() -> int:
    failed = [name for name, edits in ORDERS.items() if run(name, edits)]
    if failed:
        print(f"failed: {failed}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
