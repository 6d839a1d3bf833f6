"""Dump the compiled HLO of the fused LM loop for the default backend.

Run: python tools/dump_fused_hlo.py [config] [out.txt]
(config from bench.py; out.txt default profiles/fused_hlo.txt)
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main() -> int:
    config = sys.argv[1] if len(sys.argv) > 1 else "kitti00_mono"
    out = sys.argv[2] if len(sys.argv) > 2 else "profiles/fused_hlo.txt"

    from bench import make_problem
    from cuda_bundle_adjustment_tpu.io.arrays import optimizer_from_problem
    from cuda_bundle_adjustment_tpu.solver.fused import optimize_fused

    problem, kwargs = make_problem(config)
    opt = optimizer_from_problem(problem, **kwargs)
    solver = opt.solver
    solver.build_structure()

    lowered = optimize_fused.lower(
        solver.graph, tuple(solver.packed), solver.plan,
        metas=solver.metas, Pa=solver.Pa, La=solver.La,
        nnz=solver.schur.nnz_blocks, do_schur=solver.do_schur,
        niterations=10, mixed=solver.mixed,
    )
    txt = lowered.compile().as_text()
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as fh:
        fh.write(txt)
    print(f"wrote {len(txt) / 1e6:.1f} MB to {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
