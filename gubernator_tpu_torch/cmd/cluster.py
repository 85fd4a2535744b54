"""Local in-process cluster binary for client development (the port of
``gubernator_tpu/cmd/cluster.py``; reference
cmd/gubernator-cluster/main.go:30-56): boots N daemons on consecutive local
ports, wires them with explicit set_peers, and serves until interrupted.

``--device`` names the device of the daemons' engines, as in
cmd/server.py: without it they run on the card and raise when there is
none; ``--device cpu`` serves on the CPU. There is no fallback.

    python -m gubernator_tpu_torch.cmd.cluster -n 3 --device cpu
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import signal
import sys

log = logging.getLogger("gubernator-cluster")


async def start_cluster(n: int, base_port: int, host: str = "127.0.0.1", device=None):
    from gubernator_tpu_torch.config import BehaviorConfig, DaemonConfig
    from gubernator_tpu_torch.service.daemon import Daemon
    from gubernator_tpu_torch.types import PeerInfo

    daemons = []
    try:
        for i in range(n):
            conf = DaemonConfig(
                grpc_address=f"{host}:{base_port + 2 * i}",
                http_address=f"{host}:{base_port + 2 * i + 1}",
                behaviors=BehaviorConfig(global_sync_wait_ms=50.0),
            )
            daemons.append(await Daemon.spawn(conf, device=device))
    except BaseException:
        # a port already taken: stop the nodes that did start
        await asyncio.gather(*(d.close() for d in daemons))
        raise
    peers = [d.peer_info() for d in daemons]
    for d in daemons:
        d.set_peers([PeerInfo(**vars(p)) for p in peers])
    return daemons


async def serve(n: int, base_port: int, stop=None, ready=None, device=None) -> None:
    daemons = await start_cluster(n, base_port, device=device)
    for d in daemons:
        log.info("node grpc=%s http=%s", d.conf.grpc_address, d.conf.http_address)
    stop = stop or asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            loop.add_signal_handler(sig, stop.set)
        except (NotImplementedError, RuntimeError):  # pragma: no cover
            pass
    if ready is not None:
        res = ready(daemons)
        if asyncio.iscoroutine(res):
            await res
    try:
        await stop.wait()
    finally:
        await asyncio.gather(*(d.close() for d in daemons))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="gubernator-cluster")
    p.add_argument("-n", "--nodes", type=int, default=6)
    p.add_argument("--base-port", type=int, default=9090)
    p.add_argument(
        "--device", default=None,
        help="device of the engines (default: the card; 'cpu' to serve on "
        "the CPU)",
    )
    args = p.parse_args(argv)
    logging.basicConfig(stream=sys.stderr, level=logging.INFO)
    log.info("starting %d-node local cluster...", args.nodes)
    try:
        asyncio.run(serve(args.nodes, args.base_port, device=args.device))
    except KeyboardInterrupt:  # pragma: no cover
        pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
