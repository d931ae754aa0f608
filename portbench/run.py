"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Loads and warms up the cell (set-up), measures for ``--seconds``, checks
what the window produced against the plain reference, and prints one
JSON object as the last line of standard output: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (and ``breakdown``
when traced), with ``check``, each compared number beside its limit,
last.  ``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1``
its per-layer metrics from a traced slice of the window.

It needs an NVIDIA card: without one, or with fewer than the cell asks
for, it exits with code 2 and prints no result.  It exits with code 3 if
JAX or the JAX package was loaded.  Every build and kernel cache stays
under ``build/`` in the checkout.
"""

from __future__ import annotations

import time

T_BOOT = time.monotonic()

import argparse  # noqa: E402
import faulthandler  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "hyperopt_tpu"}
EXIT_NO_CARD, EXIT_JAX = 2, 3


def process_start_monotonic():
    """The monotonic time this process started (``/proc``), else the
    time this file began to run."""
    try:
        ticks = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
        since_boot = ticks / os.sysconf("SC_CLK_TCK")
        age = time.clock_gettime(time.CLOCK_BOOTTIME) - since_boot
        return min(T_BOOT, time.monotonic() - age)
    except (OSError, ValueError, IndexError, AttributeError):
        return T_BOOT


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)


def power_limit_w():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=10).stdout
        return float(out.split()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def environment():
    """Caches of the program and of torch inside the checkout; threads."""
    build = ROOT / "build"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    # one process to a card with few threads: the host's work is serial,
    # and idle OpenMP workers only take cores from it
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"


def run_cell(bench, cell_name, seed, seconds, trace, device="cuda", patch=None, sample=None):
    """One run of a cell: ``(result, check_rows, run)``.  ``device="cpu"``,
    ``patch`` (a callable given the driver context before the run) and
    ``sample`` (suggests judged) are for the CPU tests only."""
    import torch

    import hyperopt_tpu_torch as T
    from portbench.core import drivers
    from portbench.reference import check

    cell = bench.cell(cell_name)
    cfg, loss_module = bench.config(cell["config"])
    traffic = bench.traffic(cell["traffic"])
    if device != "cpu":
        from hyperopt_tpu_torch.ops import kernel_build

        kernel_build.set_build_dir(ROOT / "build" / "kernels")
    ctx = drivers.Ctx(T, torch, cfg, loss_module, traffic, seed, seconds, trace, device)
    if patch is not None:
        patch(ctx)
    marks = {}
    start = process_start_monotonic()

    def t_mark(name):
        marks[name] = time.monotonic() - start

    run = drivers.DRIVERS[traffic["driver"]](ctx, t_mark)
    run["setup_s"] = run["t0"] - start
    run["marks"] = marks
    run["cfg"] = cfg
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()
    numbers, info = check.judge(ctx.cfg, ctx.loss, run["studies"], run["failed"], seed,
                                device if device == "cpu" else "cuda",
                                sample=check.SAMPLE if sample is None else sample)
    correct, rows = check.verdict(numbers, bench.limits(cell_name))
    metrics = {}
    for m in bench.metrics_for(cell_name, trace):
        value = bench.metric(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device != "cpu" else "cpu",
           "kind": torch.cuda.get_device_name(0) if device != "cpu" else "cpu",
           "count": int(cell["chips"]),
           "memory_peak_bytes": int(run["memory_peak_bytes"])}
    result = {"correct": bool(correct), "attempted": int(run["attempted"]),
              "failed": int(run["failed"]), "metrics": metrics, "device": dev}
    from hyperopt_tpu_torch.ops import fused_kernel

    probe = fused_kernel.probe_result()
    if probe is not None:
        # the program's scorer probe picks kernel #1 or #2 once per process
        dev["scorer_kernel"] = "fused_suggest" if probe["fused"] else "pair_score"
    if trace and "slice" in run:
        from portbench.core.trace import breakdown

        dev["busy_s"] = run["slice"]["busy_s"]
        dev["window_s"] = run["slice"]["window_s"]
        result["breakdown"] = breakdown(run["slice"])
    result["check"] = {name: {"value": value, "limit": limit} for name, value, limit in rows}
    run["check_info"] = info
    return result, rows, run


def main(argv=None):
    args = parse(argv)
    faulthandler.enable()
    environment()
    sys.path.insert(0, str(ROOT))
    from portbench.core.registry import Bench

    bench = Bench(ROOT)
    cell = bench.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: the cell needs {cell['chips']} CUDA card(s); this machine "
              f"has {n}. No result.", file=sys.stderr)
        return EXIT_NO_CARD
    import hyperopt_tpu_torch

    pkg = Path(hyperopt_tpu_torch.__file__).resolve()
    if ROOT not in pkg.parents:
        print(f"portbench: the program was imported from {pkg}, outside the checkout",
              file=sys.stderr)
        return 1
    result, rows, run = run_cell(bench, args.workload, args.seed, args.seconds,
                                 bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"portbench: modules of JAX or of the JAX package were loaded: {bad}. "
              "No result.", file=sys.stderr)
        return EXIT_JAX
    limit = power_limit_w()
    if limit is not None:
        result["device"]["power_limit_w"] = limit
    from hyperopt_tpu_torch.ops import fused_kernel

    info = {"setup_marks_s": run["marks"], "fused_probe": fused_kernel.probe_result(),
            **run["check_info"]}
    info["speculation"] = run["speculation"]
    print("portbench: " + json.dumps(info), file=sys.stderr)
    for name, value, lim in rows:
        print(f"check {name} = {value} (limit {lim})", file=sys.stderr)
    sys.stderr.flush()
    check = result.pop("check")
    result["check"] = check  # the last key of the line
    print(json.dumps(_finite(result), allow_nan=False))
    return 0


def _finite(x):
    """``x`` with every NaN or infinite number as null (JSON has none)."""
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_finite(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return None
    return x


if __name__ == "__main__":
    sys.exit(main())
