"""Host service layer of the port: the daemon of one data center.

``Daemon`` and ``DaemonMetrics`` load on first use, so the serving pipeline
under them (``wire``, ``batcher``, ``runner``) imports where grpc, aiohttp,
protobuf and prometheus_client are not installed.
"""

__all__ = ["Daemon", "DaemonMetrics", "parse_metrics"]


def __getattr__(name):
    if name == "Daemon":
        from gubernator_tpu_torch.service.daemon import Daemon

        return Daemon
    if name in ("DaemonMetrics", "parse_metrics"):
        from gubernator_tpu_torch.service import metrics

        return getattr(metrics, name)
    raise AttributeError(name)
