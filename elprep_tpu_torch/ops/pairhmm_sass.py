"""Instruction counts of the PairHMM warp kernel's main loops, read from
its SASS. A probe for reading the kernel, on no path of the program.

    python -m elprep_tpu_torch.ops.pairhmm_sass             # build, cuobjdump -sass
    python -m elprep_tpu_torch.ops.pairhmm_sass listing.txt # a saved listing

For each instantiation ``pairhmm_warp_kernel<RMAX>`` it prints the size
of every loop (a conditional branch back to an earlier address: the
diagonal loop, one body per rows-per-lane count R up to RMAX) and how
many of its instructions are FMUL or FADD. Without a listing it builds
the kernel library and needs ``cuobjdump`` beside ``nvcc``.
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess
import sys


def warp_loops(sass: str) -> dict:
    """{RMAX: [(instructions, FMUL + FADD) of each loop, fewest FMUL +
    FADD first]} for each warp-kernel instantiation in a ``cuobjdump
    -sass`` listing."""
    out = {}
    for body in sass.split("Function : ")[1:]:
        m = re.search(r"pairhmm_warp_kernelILi(\d+)E", body.split("\n", 1)[0])
        if not m:
            continue
        ins = [(int(a, 16), t.strip()) for a, t in
               re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body)]
        loops = []
        for addr, text in ins:
            br = re.match(r"@!?P\d\s+BRA\s+0x([0-9a-f]+)", text)
            if br and int(br.group(1), 16) < addr:
                lo = int(br.group(1), 16)
                ops = [t.split()[1] if t.startswith("@") else t.split()[0]
                       for a, t in ins if lo <= a <= addr]
                loops.append((len(ops), sum(o in ("FMUL", "FADD") for o in ops)))
        out[int(m.group(1))] = sorted(loops, key=lambda x: x[1])
    return out


def _listing() -> str:
    from . import pairhmm_cuda

    lib = pairhmm_cuda.library()
    tool = os.path.join(os.path.dirname(pairhmm_cuda._nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        tool = shutil.which("cuobjdump")
    if not tool:
        raise RuntimeError("cuobjdump not found beside nvcc or on PATH")
    return subprocess.run([tool, "-sass", lib.path], capture_output=True, text=True,
                          check=True, timeout=300).stdout


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv:
        with open(argv[0]) as fh:
            sass = fh.read()
    else:
        sass = _listing()
    loops = warp_loops(sass)
    if not loops:
        raise RuntimeError("no pairhmm_warp_kernel in the SASS listing")
    for rmax, sizes in sorted(loops.items()):
        print("pairhmm_warp_kernel<%d>: loops (two diagonals each) %s instructions, "
              "of them FMUL+FADD %s" % (rmax, [n for n, _ in sizes],
                                        [fp for _, fp in sizes]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
