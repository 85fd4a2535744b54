"""Server binary — boot one daemon from the environment and serve until
SIGTERM/SIGINT (reference cmd/gubernator/main.go:50-131).

Flags: the reference's two, --config (env file) and --debug, plus --device,
the device of the daemon's engine. Without it the daemon runs on the card
and raises when there is none; ``--device cpu`` serves on the CPU. There is
no config field and no environment fallback to the CPU.

    python -m gubernator_tpu_torch --device cpu
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import signal
import sys
from typing import Optional

log = logging.getLogger("gubernator_tpu_torch")

LEVELS = {
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warn": logging.WARNING,
    "warning": logging.WARNING,
    "error": logging.ERROR,
}


def setup_logging(level: str, debug: bool = False) -> None:
    logging.basicConfig(
        stream=sys.stderr,
        level=logging.DEBUG if debug else LEVELS.get(level.lower(), logging.INFO),
        format="%(asctime)s %(levelname)s %(name)s %(message)s",
    )


async def serve(
    config_file: str = "",
    debug: bool = False,
    stop: Optional[asyncio.Event] = None,
    ready=None,
    device=None,
):
    """Spawn a daemon on `device` (None = the card) and run until `stop` (or
    a signal) fires. `ready` is called with the live Daemon once listeners
    answer — the test seam, and the WaitForConnect analog (reference
    daemon.go:493-530)."""
    from gubernator_tpu_torch.config import setup_daemon_config
    from gubernator_tpu_torch.service.daemon import Daemon

    conf = setup_daemon_config(config_file)
    setup_logging(conf.log_level, debug)
    daemon = await Daemon.spawn(conf, device=device)
    log.info(
        "gubernator-tpu-torch serving on %s: grpc=%s http=%s instance=%s",
        daemon.engine.device if hasattr(daemon.engine, "device") else device,
        conf.grpc_address, conf.http_address, conf.instance_id,
    )
    stop = stop or asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            loop.add_signal_handler(sig, stop.set)
        except (NotImplementedError, RuntimeError):  # pragma: no cover
            pass
    if ready is not None:
        res = ready(daemon)
        if asyncio.iscoroutine(res):
            await res
    try:
        await stop.wait()
    finally:
        log.info("caught signal; shutting down")
        await daemon.close()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="gubernator-tpu-torch",
        description="rate-limiting daemon on PyTorch and CUDA",
    )
    p.add_argument("--config", default="", help="environment config file")
    p.add_argument("--debug", action="store_true", help="enable debug logging")
    p.add_argument(
        "--device", default=None,
        help="device of the engine (default: the card; 'cpu' to serve on "
        "the CPU)",
    )
    args = p.parse_args(argv)
    try:
        asyncio.run(serve(args.config, args.debug, device=args.device))
    except KeyboardInterrupt:  # pragma: no cover
        pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
