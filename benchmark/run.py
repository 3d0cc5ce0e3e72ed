"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Set-up renders the cell's scene on the card from the seed, builds the
node's messages, builds ``TaichiSLAMNodeCore`` from the configuration's
parameters (no capacity pinned, no bucket held) and runs the traffic's
warm-up frames. The window then drives the node as its ROS shell does:
each frame's messages staged with ``stage_depth`` (latest wins), then
``process_taichi()`` and ``handle_comm()``. After the window the plain
reference replays the frames the node took and the map and published
clouds are compared (``check.py``).

The last line of standard output is the result: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks`` (each compared number and its limit,
also the last lines of standard error). Without a card, with fewer cards
than the cell asks for, or with a JAX module loaded once the window has
closed, it prints no result and exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
REFUSED = ("jax", "jaxlib", "flax", "taichislam_tpu")


def process_start() -> float:
    """Wall time at which this process started (Linux), else now."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        ticks = os.sysconf("SC_CLK_TCK")
        with open("/proc/stat") as f:
            btime = next(int(ln.split()[1]) for ln in f
                         if ln.startswith("btime"))
        return btime + int(fields[19]) / ticks
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


def environment(root: Path) -> None:
    """The run's environment, set before torch is imported: every build
    and kernel cache at a fixed path inside the checkout (the port builds
    its kernels into ``build/kernels/`` there), no JAX behind a library,
    and one thread in the host's intra-op pools. With the default pool of
    one thread a core, the pool's threads spin after each parallel host
    copy and burn 1.5-2 cores beside the node's own thread, whose speed
    then varies from run to run with where they land."""
    base = root / "build" / "benchmark_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "nv_compute")):
        os.environ[var] = str(base / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS",
                "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"


def refused_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)} &
                  set(REFUSED))


def main(argv=None) -> int:
    t_proc = process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    environment(ROOT)

    import torch
    torch.set_num_threads(1)
    from benchmark.cells import Cell
    from benchmark.harness import run_cell

    cell = Cell(args.workload)
    if not torch.cuda.is_available():
        print("benchmark: no CUDA device", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {cell.name} needs {cell.chips} devices, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    if cell.limits is None:
        print(f"benchmark: no limits for {cell.name} (checks/"
              f"{cell.name}.json)", file=sys.stderr)
        return 2
    line = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                    torch.device("cuda", 0), t_proc=t_proc)
    bad = refused_modules()
    if bad:
        print(f"benchmark: refused modules loaded: {bad}", file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
