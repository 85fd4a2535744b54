"""Load-generator CLI — the benchmarking client (the port of
``gubernator_tpu/cmd/cli.py``; reference cmd/gubernator-cli/main.go:51-227).

Generates a corpus of random token-bucket limits (2000 by default, limit
1-1000, duration 500ms-6s, BATCHING), then replays GetRateLimits against an
endpoint with bounded concurrency and an optional open-loop request rate,
logging OVER_LIMIT responses. Adds what the reference's CLI lacks: a latency
histogram (p50/p99/max) and a --seconds bound so runs terminate. Every
random draw comes from a ``random.Random`` its caller may seed.
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import random
import string
import sys
import time
from typing import List, Optional

log = logging.getLogger("gubernator-cli")


def random_string(rng: random.Random, n: int = 10) -> str:
    # reference client.go RandomString
    return "".join(rng.choices(string.ascii_letters + string.digits, k=n))


def make_rate_limits(count: int, rng: Optional[random.Random] = None):
    """The reference's corpus: random limits/durations (main.go:120-132),
    drawn from `rng` (a fresh generator when None)."""
    from gubernator_tpu_torch.proto import gubernator_pb2 as pb

    rng = rng or random.Random()
    return [
        pb.RateLimitReq(
            name=f"gubernator-cli-{i}",
            unique_key=random_string(rng, 10),
            hits=1,
            limit=rng.randint(1, 999),
            duration=rng.randint(500, 6000),
            behavior=pb.BATCHING,
            algorithm=pb.TOKEN_BUCKET,
        )
        for i in range(count)
    ]


class OpenLoopLimiter:
    """Paces request starts at `rate`/s independent of completions (the
    golang.org/x/time/rate analog the reference CLI uses, main.go:135-141)."""

    def __init__(self, rate: float):
        self.interval = 1.0 / rate
        self._next = time.perf_counter()

    async def wait(self) -> None:
        now = time.perf_counter()
        self._next = max(self._next + self.interval, now - 10 * self.interval)
        delay = self._next - now
        if delay > 0:
            await asyncio.sleep(delay)


RESERVOIR_CAP = 100_000


class Stats:
    """Latencies go into a bounded reservoir sample (uniform over the run) so
    endless soak runs report percentiles in O(1) memory; max is exact. The
    reservoir draws from `rng` (a fresh generator when None)."""

    def __init__(self, rng: Optional[random.Random] = None):
        self._rng = rng or random.Random()
        self.requests = 0
        self.checks = 0
        self.over_limit = 0
        self.errors = 0
        self.latencies: List[float] = []
        self.max_latency = 0.0
        self._observed = 0

    def observe(self, latency_s: float) -> None:
        self.max_latency = max(self.max_latency, latency_s)
        self._observed += 1
        if len(self.latencies) < RESERVOIR_CAP:
            self.latencies.append(latency_s)
        else:
            j = self._rng.randrange(self._observed)
            if j < RESERVOIR_CAP:
                self.latencies[j] = latency_s

    def report(self, elapsed: float) -> dict:
        lat = sorted(self.latencies)

        def pct(p):
            return lat[min(len(lat) - 1, int(p * len(lat)))] * 1e3 if lat else 0.0

        return {
            "elapsed_s": round(elapsed, 2),
            "requests": self.requests,
            "checks": self.checks,
            "checks_per_sec": round(self.checks / max(elapsed, 1e-9), 1),
            "over_limit": self.over_limit,
            "errors": self.errors,
            "latency_ms": {
                "p50": round(pct(0.50), 2),
                "p99": round(pct(0.99), 2),
                "max": round(self.max_latency * 1e3, 2),
            },
        }


async def run(args, stats: Stats) -> None:
    from gubernator_tpu_torch.client import V1Client
    from gubernator_tpu_torch.proto import gubernator_pb2 as pb

    client = V1Client(args.endpoint, timeout_s=args.timeout)
    corpus = make_rate_limits(args.limits)
    limiter = OpenLoopLimiter(args.rate) if args.rate > 0 else None
    sem = asyncio.Semaphore(args.concurrency)
    deadline = time.perf_counter() + args.seconds if args.seconds else None
    stop = asyncio.Event()

    async def send(batch) -> None:
        async with sem:
            t0 = time.perf_counter()
            try:
                resp = await client.get_rate_limits(batch)
            except Exception as exc:
                stats.errors += 1
                if not args.quiet:
                    log.error("GetRateLimits: %s", exc)
                return
            stats.observe(time.perf_counter() - t0)
            stats.requests += 1
            stats.checks += len(batch)
            for item, r in zip(batch, resp.responses):
                if r.status == pb.OVER_LIMIT:
                    stats.over_limit += 1
                    if not args.quiet:
                        log.info("Overlimit! name=%s", item.name)

    tasks: set = set()
    try:
        while not stop.is_set():
            for i in range(0, len(corpus), args.checks):
                if deadline and time.perf_counter() > deadline:
                    stop.set()
                    break
                if limiter:
                    await limiter.wait()
                else:
                    # natural backpressure: don't build an unbounded task pile
                    while len(tasks) > args.concurrency * 2:
                        _, tasks = await asyncio.wait(
                            tasks, return_when=asyncio.FIRST_COMPLETED
                        )
                t = asyncio.create_task(send(corpus[i : i + args.checks]))
                tasks.add(t)
                t.add_done_callback(tasks.discard)
            if args.once:
                break
        if tasks:
            await asyncio.gather(*tasks, return_exceptions=True)
    finally:
        await client.close()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="gubernator-cli", description="gubernator-tpu load generator"
    )
    p.add_argument("-e", "--endpoint", default="", help="gRPC endpoint address")
    p.add_argument("--config", default="", help="environment config file")
    p.add_argument("--concurrency", type=int, default=1, help="concurrent requests")
    p.add_argument(
        "--timeout", type=float, default=0.1, help="request timeout seconds"
    )
    p.add_argument("--checks", type=int, default=1, help="rate checks per request")
    p.add_argument(
        "--rate", type=float, default=0, help="open-loop request rate, 0 = closed loop"
    )
    p.add_argument("--limits", type=int, default=2000, help="distinct rate limits")
    p.add_argument(
        "--seconds", type=float, default=0, help="stop after N seconds (0 = endless)"
    )
    p.add_argument("--once", action="store_true", help="one pass over the corpus")
    p.add_argument("-q", "--quiet", action="store_true")
    args = p.parse_args(argv)
    logging.basicConfig(
        stream=sys.stderr,
        level=logging.ERROR if args.quiet else logging.INFO,
        format="%(asctime)s %(levelname)s %(message)s",
    )
    if not args.endpoint:
        import os

        if args.config:
            from gubernator_tpu_torch.config import load_config_file

            load_config_file(args.config)
        args.endpoint = os.environ.get("GUBER_GRPC_ADDRESS", "")
    if not args.endpoint:
        log.error(
            "please provide a GRPC endpoint via -e, from a config file via "
            "--config, or set the env GUBER_GRPC_ADDRESS"
        )
        return 1

    stats = Stats()
    t0 = time.perf_counter()
    try:
        asyncio.run(run(args, stats))
    except KeyboardInterrupt:
        pass
    import json

    print(json.dumps(stats.report(time.perf_counter() - t0)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
