"""Trace one fused ``optimize(10)`` on the GPU and reduce the device trace.

Prints the device's busy and idle share over the traced window, the top
device operations by total time, and the trace's plane and line names (look
at them once by hand before trusting the reduction).

Run on the GPU:  python tools/trace_fused.py [config] [outdir]
(config from bench.py, default kitti00_mono; outdir default
profiles/trace_<config>)
"""

from __future__ import annotations

import glob
import os
import sys
import time
from collections import defaultdict

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax  # noqa: E402


def _union_ns(intervals) -> float:
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def reduce_trace(path: str, top: int = 30) -> dict:
    """Busy/idle share and per-op totals of the GPU planes of one
    ``*.xplane.pb``.  Kernel events are read from the stream lines; the
    derived "XLA Modules"/"XLA Ops" lines are skipped."""
    pd = jax.profiler.ProfileData.from_file(path)
    ops = defaultdict(lambda: [0, 0.0])
    intervals = []
    for plane in pd.planes:
        print(f"plane {plane.name!r}: lines {[ln.name for ln in plane.lines]}")
        if not plane.name.startswith("/device:GPU"):
            continue
        for ln in plane.lines:
            if ln.name.startswith("XLA"):
                continue
            for ev in ln.events:
                intervals.append((ev.start_ns, ev.start_ns + ev.duration_ns))
                ops[ev.name][0] += 1
                ops[ev.name][1] += ev.duration_ns
    if not intervals:
        raise RuntimeError(f"no GPU kernel events in {path}")
    window = max(e for _, e in intervals) - min(s for s, _ in intervals)
    busy = _union_ns(intervals)
    rows = sorted(ops.items(), key=lambda kv: -kv[1][1])
    for name, (cnt, ns) in rows[:top]:
        print(f"  {ns / 1e6:10.3f} ms  x{cnt:<6d} {name[:110]}")
    return dict(window_ms=window / 1e6, busy_ms=busy / 1e6,
                idle_share=1.0 - busy / window)


def main(argv: list[str]) -> int:
    from bench import make_problem
    from cuda_bundle_adjustment_tpu.io.arrays import optimizer_from_problem
    from cuda_bundle_adjustment_tpu.utils.runtime import (
        enable_compile_cache,
        gpu_name_and_power_limit,
        require_gpu,
        set_xla_gpu_flags,
    )

    config = argv[0] if argv else "kitti00_mono"
    outdir = argv[1] if len(argv) > 1 else f"profiles/trace_{config}"
    set_xla_gpu_flags()
    enable_compile_cache()
    jax.config.update("jax_enable_x64", True)
    require_gpu()
    card = gpu_name_and_power_limit().splitlines()[0]

    problem, kwargs = make_problem(config)
    opt = optimizer_from_problem(problem, **kwargs)
    opt.optimize(10)  # compile + warm
    jax.block_until_ready(opt.solver.graph.q)

    opt = optimizer_from_problem(problem, **kwargs)
    opt.solver.build_structure()
    jax.profiler.start_trace(outdir)
    t0 = time.perf_counter()
    opt.optimize(10)
    jax.block_until_ready(opt.solver.graph.q)
    dt = time.perf_counter() - t0
    jax.profiler.stop_trace()
    print(f"traced optimize(10) [{config}]: {dt * 1e3:.3f} ms host clock; "
          f"{card}")
    path = sorted(glob.glob(f"{outdir}/**/*.xplane.pb", recursive=True))[-1]
    r = reduce_trace(path)
    print(f"[{config}] device window {r['window_ms']:.3f} ms, busy "
          f"{r['busy_ms']:.3f} ms, idle share {r['idle_share']:.4f}; {card}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
