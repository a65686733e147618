"""The layout study's probe beside the factor it mirrors, in SASS: counts of
the instructions that make the skeleton in ``sol_kernel`` (the probe,
``hybdrt_torch/csrc/chol_layouts.cu``) and in ``factor_kernel``
(``chol_factor_lane``, ``csrc/chol_lane.cu``) at the tiles a thread of n,
their registers as ``ptxas`` reports them, and the blocks of each one SM of
the card holds (``smem_sol.occupancy``). The probe should show the factor's
16-byte shared loads, shuffles and barriers, one multiply where the factor
has one fma, and the factor's blocks per SM. Beside them, the same counts
for ``chol_factor_solve_lane``'s kernel (``factor_solve_kernel``) and the
layout study's panel-blocked factor-solve on its skeleton
(``factor_solve_kb_kernel``), with the adds and the local-memory traffic
of spilled registers. Static counts: a loop's body counts once. Run from the
repository root on a machine with a CUDA card and the CUDA toolkit:

    python -m hybdrt_torch.experiments.probe_sass [--n 93] [--sass FILE]

``--sass`` writes the kernels' SASS to FILE.
"""
import argparse
import re
import subprocess
from pathlib import Path

import torch

from ..csrc import build
from ..ops import chol_lane
from . import smem_sol

# fma, add, multiply, reciprocal square root, shared loads of 4, 8 and 16
# bytes, shuffles, block barriers, local (spill) loads and stores
OPS = {"FFMA": r"\bFFMA\b", "FADD": r"\bFADD\b", "FMUL": r"\bFMUL\b",
       "MUFU.RSQ": r"\bMUFU\.RSQ\b",
       "LDS": r"\bLDS\b(?![.\w])", "LDS.64": r"\bLDS(?:\.\w+)*\.64\b",
       "LDS.128": r"\bLDS(?:\.\w+)*\.128\b", "SHFL.IDX": r"\bSHFL\.IDX\b",
       "BAR.SYNC": r"\bBAR\.SYNC\b", "LDL": r"\bLDL\b", "STL": r"\bSTL\b"}


def label(mangled):
    """``factor_kernel<f,5>`` from a mangled kernel name."""
    m = re.search(r"([a-z_]+_kernel)(?:I(\w*?)E+v)?", mangled)
    if m is None:
        return mangled
    args = [t or v for t, v in re.findall(r"^([fd])|L[ib](\d+)", m.group(2) or "")]
    return m.group(1) + (f"<{','.join(args)}>" if args else "")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=93)
    ap.add_argument("--sass", type=Path, default=None)
    args = ap.parse_args()
    threads, tpt, _ = chol_lane.reg_geometry(args.n, torch.float32)
    names = (f"sol_kernel<{tpt}>", f"factor_kernel<f,{tpt}>", f"factor_solve_kernel<f,{tpt},1>",
             f"factor_solve_kb_kernel<{tpt}>")
    lib = build.build()
    cuobjdump = Path(build.find_nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    blocks = {label(b.split("\n", 1)[0].strip()): b
              for b in re.split(r"\n\s*Function : ", sass)[1:]}
    regs = {}
    name = None
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "Compiling entry function" in line:
            name = label(line.split("'")[1])
        elif "Used" in line and "registers" in line and name is not None:
            regs[name] = int(re.search(r"Used (\d+) registers", line).group(1))
            name = None
    print(f"n = {args.n}, float32: {threads} threads of {tpt} tiles")
    for k in names:
        counts = {op: len(re.findall(pat, blocks[k])) for op, pat in OPS.items()}
        print(f"{k}: {regs.get(k)} registers; " + ", ".join(f"{op} {c}" for op, c in counts.items()))
    probe, factor = smem_sol.occupancy(args.n)
    print(f"blocks an SM holds: probe {probe}, chol_factor_lane {factor}")
    if args.sass is not None:
        args.sass.parent.mkdir(parents=True, exist_ok=True)
        args.sass.write_text("".join(f"// {k}\n{blocks[k]}\n" for k in names))


if __name__ == "__main__":
    main()
