"""The control of the judge: the reference put in the program's place with
one guarantee broken. It answers every item from the seeded table and
never applies a hit (a replica that is never synced: stale answers), over
the requests a run of the cell sends, and the same judge counts the wrong
answers. The benchmark's own runs do not run it.

    python3 -m benchmark.control --workload <cell> --seeds 1,2,3 --requests <n>
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from benchmark import generator
from benchmark.cell import clock_for
from benchmark.reference import keyhash, limiter
from benchmark.registry import Registry


def control_reading(cell_name: str, seed: int, requests: int, cfg: dict = None,
                    traffic: dict = None) -> dict:
    """Wrong answers of the stale control over the first `requests`
    requests of the cell's window for `seed`."""
    reg = Registry()
    cell = reg.cell(cell_name)
    cfg = cfg or reg.config(cell["config"])
    traffic = traffic or reg.traffic(cell["traffic"])
    per = int(traffic["items_per_request"])
    seconds = requests * per / float(traffic["budget_items_per_s"]) + 1.0
    inp = generator.Inputs(cfg, traffic, seed, seconds)
    clock = clock_for(cfg, seed)
    kid = inp.window_ids[:requests].reshape(-1)
    hits = inp.hits_of(np.arange(kid.size))
    # the control answers each request alone: a flush of one request
    flush, pos = np.arange(kid.size) // per, np.arange(kid.size)
    fps = keyhash.fingerprints(generator.hash_keys(inp.name, np.arange(int(cfg["keys"]))))
    closed = limiter.closed_keys(fps, keyhash.n_buckets_for(int(cfg["slots"])))
    seeded = limiter.seeded(cfg, clock, inp.seed_hits, inp.leaky)
    ans = limiter.stale_answers(cfg, clock, kid, seeded, hits)
    j = limiter.judge(cfg, clock, kid, ans, seeded, closed, hits, flush, pos)
    return {"workload": cell_name, "seed": seed, "requests": requests, "rows": int(kid.size),
            "wrong_answers": int(j["wrong"].sum())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the stale-replica control of the judge")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--requests", type=int, required=True)
    args = ap.parse_args(argv)
    for s in args.seeds.split(","):
        print(json.dumps(control_reading(args.workload, int(s), args.requests)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
