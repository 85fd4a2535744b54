"""Run one cell of the port's benchmark once and print one JSON line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

With ``--trace 0`` the line carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, the profiled slice's busy and window
seconds and a breakdown. Every run judges every answer of the window
against the reference (``correct``) and prints the numbers compared, each
beside its limit, as its last lines on standard error and under ``checks``,
the line's last key. It refuses to run without a CUDA card, and refuses to
print a result if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "gubernator_tpu")


def process_age_s() -> float:
    """Seconds since this process started (Linux), 0 where unknown."""
    try:
        start_ticks = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


def prepare_environment() -> list:
    """Fixed cache directories inside the checkout, no JAX for libraries
    that would load it, and the program at its default knobs: every
    ``GUBER_*`` variable removed. Returns the names removed."""
    cache = ROOT / "build" / "bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    dropped = sorted(k for k in os.environ if k.startswith("GUBER_"))
    for k in dropped:
        del os.environ[k]
    return dropped


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def checks_of(judged: dict) -> dict:
    """The numbers compared, each with its limit (all exact: limit 0)."""
    return {
        "wrong_answers": {"value": judged["wrong_rows"], "limit": 0},
        "missing_answers": {"value": judged["missing_rows"], "limit": 0},
        "malformed_records": {"value": judged["malformed"], "limit": 0},
        "wrong_state_keys": {"value": judged["state_wrong"], "limit": 0},
        "seed_errors": {"value": judged["seed_errors"], "limit": 0},
    }


def context(res: dict) -> dict:
    """What the metric readers read: the window's counts and clocks, and
    the profiled slice."""
    w, j = res["window"], res["judged"]
    done, sent = w["done"], w["sent"]
    in_window = done <= w["t_close"]
    return {
        "requests": int(sent.size),
        "items": int(sent.size) * res["per_request"],
        "answered_in_window": int(j["answered"][in_window].sum()),
        "answered": int(j["answered"].sum()),
        "seconds": res["seconds"],
        "setup_s": res["setup_s"],
        "latency_s": (done - sent),
        "counters": w["counters"],
        "trace": res["trace"],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    process_age_at_start = process_age_s() - (time.perf_counter() - T_START)
    dropped = prepare_environment()
    log = lambda *a: print(*a, file=sys.stderr, flush=True)  # noqa: E731
    if dropped:
        log(f"benchmark: ignoring {', '.join(dropped)} (the program runs at its defaults)")

    from benchmark.registry import Registry

    reg = Registry()
    cell = reg.cell(args.workload)
    cfg = reg.config(cell["config"])
    traffic = reg.traffic(cell["traffic"])

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        log(f"benchmark: {cell['chips']} CUDA card(s) needed, "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found")
        return 2
    log(f"set-up: torch and {torch.cuda.get_device_name(0)} ready at "
        f"{time.perf_counter() - T_START + process_age_at_start:.2f} s")
    result = measure(reg, cell, cfg, traffic, args.seed, args.seconds, bool(args.trace),
                     T_START - process_age_at_start, log=log)
    bad = forbidden_modules()
    if bad:
        log(f"benchmark: the run loaded {', '.join(bad)}; no result")
        return 3
    checks = result["checks"]
    for k, v in checks.items():
        log(f"check {k}: {v['value']} (limit {v['limit']})")
    print(json.dumps(result), flush=True)
    return 0


def _rate_by(w: dict, answered, step: float) -> list:
    """Decisions a second in each `step` seconds of the window (how steady
    the host was inside one run)."""
    import numpy as np

    t = w["done"] - w["t_open"]
    inside = t <= w["t_close"] - w["t_open"]
    return list(np.bincount((t[inside] // step).astype(np.int64),
                            weights=answered[inside]) / step)


def torch_threads() -> int:
    import torch

    return torch.get_num_threads()


def device_info(count: int, peak: int) -> dict:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
            "memory_peak_bytes": peak, "power_limit": power_limit()}


def power_limit() -> str:
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def measure(reg, cell, cfg, traffic, seed, seconds, trace, t_start, log,
            device=None) -> dict:
    """Run the cell and build its result line (without printing it)."""
    from benchmark.cell import run_cell

    wanted = reg.per_layer(cell["name"]) if trace else reg.end_to_end(cell["name"])
    # the window is profiled in traced runs, and in untraced ones where an
    # end-to-end metric comes from the device's trace
    profile = trace or any(m["source"] == "device_trace" for m in wanted)
    res = run_cell(cfg, traffic, seed, seconds, profile and device is None, t_start,
                   device=device, log=log, stages=trace)
    ctx = context(res)
    j = res["judged"]
    correct = all(v["value"] <= v["limit"] for v in checks_of(j).values())
    metrics = {}
    for m in wanted:
        v = reg.reader(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    if not trace and device is None and len(metrics) < len(wanted):
        raise RuntimeError("no reading of end-to-end metric(s) "
                           f"{sorted({m['name'] for m in wanted} - set(metrics))}")
    count = int(cell["chips"])
    dev = (device_info(count, res["memory_peak_bytes"]) if device is None else
           {"platform": "cpu", "kind": "cpu", "count": count, "memory_peak_bytes": 0})
    out = {"correct": bool(correct), "attempted": ctx["items"],
           "failed": ctx["items"] - int(j["answered"].sum()),
           "metrics": metrics, "device": dev}
    tr = res["trace"]
    if trace and tr is not None:
        dev["busy_s"] = tr["busy_s"]
        dev["window_s"] = tr["window_s"]
        out["breakdown"] = {"device_ops": tr["top_ops"], "idle_gaps": tr["idle_gaps"]}
    out["detail"] = {k: v for k, v in j.items() if k != "answered"}
    out["detail"].update(requests=ctx["requests"],
                         answered_in_window=ctx["answered_in_window"],
                         flushes=ctx["counters"]["flushes"],
                         dispatches=ctx["counters"]["dispatches"],
                         fused_flushes=ctx["counters"]["fused_flushes"],
                         column_flushes=ctx["counters"]["column_flushes"],
                         dropped=ctx["counters"]["dropped"],
                         evicted_unexpired=ctx["counters"]["evicted_unexpired"],
                         stage_ms={k: (t / c * 1e3 if c else None)
                                   for k, (c, t) in ctx["counters"]["stages"].items()},
                         stage_count={k: c for k, (c, t) in ctx["counters"]["stages"].items()},
                         process_cpu_s=res["window"]["process_cpu_s"],
                         torch_threads=torch_threads(),
                         rate_by_2s=_rate_by(res["window"], j["answered"], 2.0))
    out["checks"] = checks_of(j)
    return out


if __name__ == "__main__":
    sys.exit(main())
