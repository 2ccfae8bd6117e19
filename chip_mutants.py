#!/usr/bin/env python3
"""Mutation check of ``chip_smoke.py``'s kernel-vs-plain tolerance, on one
CUDA card: ``python3 chip_mutants.py`` from the repository root.

For each mutant below, the package and ``chip_smoke.py`` are copied into a
temporary directory, one deliberate fault is written into the copy's
``csrc/egcl_allpairs.cu``, and a fresh process builds that copy and prints
max |kernel - plain| / max |plain| per output at ``chip_smoke.py``'s main
and ragged shapes, bf16 and f32 -- the reading ``chip_smoke.py`` holds
against ``TOL``. The unmutated source runs first as the control. The
checkout itself is never modified.
"""

import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = "enflow_tpu_torch/csrc/egcl_allpairs.cu"

# name -> (text in the source, its replacement)
MUTANTS = {
    "control": None,
    "j-side sums drop each chunk's last row": (
        "for (int r = q; r < nrows; r += N)",
        "for (int r = q; r < nrows - 1; r += N)"),
    "i-side sums drop each chunk's last row": (
        "for (int r = lo; r < hi; ++r)",
        "for (int r = lo; r < hi - (hi == nrows); ++r)"),
    "valid ignores mask_j (padded neighbours count)": (
        "s.valid[r] = s.mask[i] * s.mask[j] *",
        "s.valid[r] = s.mask[i] *"),
    "r2 not rounded to the compute dtype before w1r": (
        "rnd<T>(rnd<T>(s.r2[r]) * s.w1r[c])",
        "rnd<T>(s.r2[r] * s.w1r[c])"),
}

READ = """
import sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from enflow_tpu_torch.ops import egcl_allpairs as ops
for sname, shape in (("main", cs.MAIN), ("ragged", cs.RAGGED)):
    for dname, dt in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        h, pos, box, mf, W, dagg, dfsum, _ = cs.edge_inputs(shape, dt, seed=11)
        k = (ops.allpairs_edges_fwd(h, pos, box, mf, W)
             + ops.allpairs_edges_bwd(h, pos, box, mf, W, dagg, dfsum))
        p = (ops.allpairs_edges_plain(h, pos, box, mf, W)
             + ops.allpairs_edges_plain_bwd(h, pos, box, mf, W, dagg, dfsum))
        rel = {n: float((a.float() - b.float()).abs().max())
               / max(float(b.float().abs().max()), 1e-6)
               for n, a, b in zip(("agg", "f_sum", "dh", "dpos"), k, p)}
        worst = max(rel.values())
        print(f"  {sname} {dname}: " + "  ".join(
            f"{n} {r:.2e}" for n, r in rel.items())
            + f"  | max {worst:.2e} vs tol {cs.TOL[dname]:g} -> "
            + ("caught" if worst > cs.TOL[dname] else "passes"), flush=True)
"""


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_mutants: no CUDA device", file=sys.stderr)
        return 1
    for name, edit in MUTANTS.items():
        with tempfile.TemporaryDirectory() as tmp:
            shutil.copytree(ROOT / "enflow_tpu_torch",
                            Path(tmp) / "enflow_tpu_torch",
                            ignore=shutil.ignore_patterns("_build",
                                                          "__pycache__"))
            shutil.copy(ROOT / "chip_smoke.py", tmp)
            src = Path(tmp) / SRC
            text = src.read_text()
            if edit is not None:
                if text.count(edit[0]) != 1:
                    raise RuntimeError(f"mutant '{name}': its text is not "
                                       f"in {SRC} exactly once")
                src.write_text(text.replace(*edit))
            print(f"[mutant] {name}", flush=True)
            subprocess.run([sys.executable, "-c", READ], cwd=tmp, check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
