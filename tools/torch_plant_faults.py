#!/usr/bin/env python3
"""Plant faults in a copy of the port's CUDA kernels and show that
``chip_smoke.py``'s element-wise kernel check fails each one.

    python3 tools/torch_plant_faults.py

Needs one NVIDIA card.  For each fault, the script copies
``horovod_tpu_torch/`` and ``chip_smoke.py`` into a fresh temporary
directory, edits one kernel source there (the checkout is never touched),
builds that copy's kernels and runs ``chip_smoke.check_kernels`` on the
flagship shape (B 8, S 1024, H 16, D 64, bf16, causal), a ragged one
(B 2, S 1000, H 8, D 128, bf16, non-causal, nonzero dlse), the latter also
on the lse route (fp32 output and dO, split into bf16 planes), and the
fp32 shape (B 2, S 1000, H 8, D 32, non-causal, nonzero dlse; q/k/v and
dO as three bf16 planes each).  Each check prints every output's worst
element as a share of its tolerance; a fault is caught when that share
exceeds 1, a split differs from its plain version, or a gradient of the
lse route lies as far from its plain version as one computed from a bf16
dO (``chip_smoke.SPLIT_GAP``).  The first three faults touch only the last
query rows or the last query tile, so a check scaled by the largest value
would barely see them.  Exits non-zero if a fault goes uncaught.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join("horovod_tpu_torch", "ops", "csrc")

# name: (source file, text to find, its replacement)
FAULTS = {
    # The forward's last query tile drops key tile 1 from P.V (l keeps it).
    "fwd: last rows skip key tile 1": (
        "flash_wgmma.cu",
        "        s[4 * j + e] = p;\n      }\n#pragma unroll\n"
        "    for (int j = 0; j < DP / 8; ++j) {",
        "        s[4 * j + e] = (t == 1 && blockIdx.y == 0) ? 0.f : p;\n"
        "      }\n#pragma unroll\n    for (int j = 0; j < DP / 8; ++j) {"),
    # dQ's last query tile skips key tile 1 (its dS is zero there).
    "dq: last rows skip key tile 1": (
        "flash_wgmma.cu",
        "        dp[4 * j + e] = p * (dp[4 * j + e] - dd[e >> 1]);\n",
        "        dp[4 * j + e] = (t == 1 && blockIdx.y == 0)\n"
        "            ? 0.f : p * (dp[4 * j + e] - dd[e >> 1]);\n"),
    # dK/dV drops the last query tile for every earlier key tile.
    "dkv: last query tile skipped": (
        "flash_wgmma.cu",
        "        if (diag && q0 + c < k0 + krow + 8 * (e >> 1)) p = 0.f;\n",
        "        if (diag && q0 + c < k0 + krow + 8 * (e >> 1)) p = 0.f;\n"
        "        if (q0 + BQ >= S && k0 < q0) p = 0.f;\n"),
    # The split's planes after the first hold it again (the lse route's dO
    # lo plane is hi: hi + lo is twice dO).
    "split: lo plane is hi": (
        "flash_wgmma.cu",
        "    v = make_float4(v.x - __low2float(h01), v.y - __high2float(h01),\n"
        "                    v.z - __low2float(h23), v.w - __high2float(h23));",
        "    v = make_float4(v.x, v.y, v.z, v.w);"),
    # dK/dV with an fp32 dO takes P_hi where its P_lo.hi product needs P_lo.
    "dkv f32do: P_lo replaced by P_hi": (
        "flash_wgmma.cu",
        "          mma_rs<DP, NC>(dvacc, plo[kk], dOt, BQ, kk, c0);",
        "          mma_rs<DP, NC>(dvacc, pa[kk], dOt, BQ, kk, c0);"),
    # dQ with an fp32 dO ignores its lo plane: dP from bf16(dO) alone.  Its
    # worst element lands near TOL; the split-precision check
    # (chip_smoke.SPLIT_GAP) reads it at the bf16 dO's gap.
    "dq f32do: lo plane dropped": (
        "flash_wgmma.cu",
        "          wgmma_ss<BK>(dp, desc_k<DP>(dOs + pn * L::bytes(BQ)",
        "          if (pn == 0) wgmma_ss<BK>(dp, desc_k<DP>(dOs + pn * "
        "L::bytes(BQ)"),
    # The fp32 forward's S leaves out Q's mid plane (its products with K's
    # hi and mid planes).  (Without Q's lo plane instead, an element moves
    # by 0.1-0.5 of the fp32 tolerance: tests/test_torch_flash_fp32.py.)
    "fwd fp32: S drops Q's mid plane": (
        "flash_wgmma.cu",
        "          wgmma_ss<FK>(s, desc_k<DP>(Qs + pair_a(pr) * L::bytes(FQ), "
        "FQ, 0, kk),",
        "          if (pair_a(pr) != 1)\n"
        "          wgmma_ss<FK>(s, desc_k<DP>(Qs + pair_a(pr) * L::bytes(FQ), "
        "FQ, 0, kk),"),
    # The fp32 dK/dV takes P's hi fragment where its P_lo.dO_hi product
    # needs the lo one.
    "dkv fp32: P_lo replaced by P_hi": (
        "flash_wgmma.cu",
        "          mma_rs<DP, NC>(dvacc, pf[kk][pair_a(pr)],",
        "          mma_rs<DP, NC>(dvacc, pf[kk][pair_a(pr) == 2 ? 0 "
        ": pair_a(pr)],"),
    # The fp32 dQ's dS.K leaves out dS's mid plane (its products with K's
    # hi and mid planes).
    "dq fp32: dS.K drops dS's mid plane": (
        "flash_wgmma.cu",
        "          mma_rs<DP, DP>(dqacc, df[kk][pair_a(pr)],",
        "          if (pair_a(pr) != 1)\n"
        "          mma_rs<DP, DP>(dqacc, df[kk][pair_a(pr)],"),
}

RUN = """
import sys, torch
sys.path.insert(0, {root!r})
import chip_smoke
from horovod_tpu_torch.ops import flash_attention as fa
name, peaks = chip_smoke._peaks(torch.cuda.get_device_name(0))
dev = torch.device("cuda", 0)
caught = 0
bf, f32 = torch.bfloat16, torch.float32
for shape in ((8, 1024, 16, 64, bf, True, False, False),
              (2, 1000, 8, 128, bf, False, True, False),
              (2, 1000, 8, 128, bf, False, True, True),
              (2, 1000, 8, 32, f32, False, True, False)):
    B, S, H, D, dtype, causal, dlse, lse_route = shape
    try:
        chip_smoke.check_kernels(fa, B, S, H, D, dtype, causal, dlse, peaks,
                                 dev, timed=False, lse_route=lse_route)
    except AssertionError as e:
        caught += 1
        print("  caught:", e)
sys.exit(0 if caught else 3)
"""


def plant(name, src, find, repl):
    with tempfile.TemporaryDirectory() as root:
        shutil.copytree(os.path.join(REPO, "horovod_tpu_torch"),
                        os.path.join(root, "horovod_tpu_torch"),
                        ignore=shutil.ignore_patterns("__pycache__"))
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), root)
        path = os.path.join(root, CSRC, src)
        with open(path) as f:
            text = f.read()
        if text.count(find) != 1:
            raise RuntimeError(f"{name}: the text to replace occurs "
                               f"{text.count(find)} times in {src}")
        with open(path, "w") as f:
            f.write(text.replace(find, repl))
        print(f"fault: {name} ({src})", flush=True)
        r = subprocess.run([sys.executable, "-c", RUN.format(root=root)],
                           cwd=root)
        return r.returncode == 0


def main() -> int:
    missed = [name for name, fault in FAULTS.items() if not plant(name,
                                                                  *fault)]
    print(f"faults caught: {len(FAULTS) - len(missed)} of {len(FAULTS)}"
          + (f"; missed {missed}" if missed else ""))
    return 1 if missed else 0


if __name__ == "__main__":
    sys.exit(main())
