"""Health probe binary for k8s liveness/readiness (the port of
``gubernator_tpu/cmd/healthcheck.py``; reference
cmd/healthcheck/main.go:34-105): GET /v1/HealthCheck with retries, exit code
2 when the daemon answers but is unhealthy, 1 on transport errors.
"""

from __future__ import annotations

import json
import os
import ssl
import sys
import time
import urllib.error
import urllib.request


class NotHealthy(Exception):
    pass


def check(
    url: str,
    attempts: int,
    delay_s: float = 0.5,
    out=sys.stdout,
    scheme: str = "http",
    ca_file: str = "",
    cert_file: str = "",
    key_file: str = "",
    strict: bool = False,
) -> None:
    """Raises NotHealthy if the daemon reports unhealthy, URLError and friends
    on transport failure; returns on success. A "degraded" status (peer
    errors / open circuit breakers — the instance still serves every
    request) passes unless `strict`: restarting a
    pod because its PEERS are unreachable only amplifies a partition. With
    TLS, probe over https trusting `ca_file`; `cert_file`/`key_file` present
    a client certificate so the probe also works against an mTLS gateway
    when no status listener is configured."""
    ok = ("healthy",) if strict else ("healthy", "degraded")
    ctx = None
    if scheme == "https":
        ctx = ssl.create_default_context(cafile=ca_file or None)
        ctx.check_hostname = False  # probes hit pod IPs, not SAN hostnames
        if not ca_file:
            ctx.verify_mode = ssl.CERT_NONE
        if cert_file and key_file:
            ctx.load_cert_chain(cert_file, key_file)
    last: Exception = RuntimeError("no attempts made")
    for i in range(max(attempts, 1)):
        req_url = f"{scheme}://{url}/v1/HealthCheck"
        print(f'checking "{req_url}": attempt={i}', file=out)
        try:
            with urllib.request.urlopen(req_url, timeout=2.0, context=ctx) as resp:
                hc = json.loads(resp.read().decode())
        except Exception as exc:  # noqa: BLE001 - retried, rethrown at the end
            last = exc
            if i < attempts - 1:
                time.sleep(delay_s)
            continue
        if hc.get("status") not in ok:
            last = NotHealthy(
                f"not healthy: status={hc.get('status')!r} "
                f"message={hc.get('message')!r} peer_count={hc.get('peer_count')} "
                f"advertise_address={hc.get('advertise_address')!r}"
            )
            if i < attempts - 1:
                time.sleep(delay_s)
            continue
        if hc.get("status") == "degraded":
            print(
                f"degraded (passing): message={hc.get('message')!r}", file=out
            )
        return
    raise last


def main(argv=None) -> int:
    # prefer the status listener (serves health without client certs in mTLS
    # clusters); fall back to the main gateway address
    url = (
        os.environ.get("GUBER_STATUS_HTTP_ADDRESS")
        or os.environ.get("GUBER_HTTP_ADDRESS")
        or "localhost:1050"
    )
    from gubernator_tpu_torch.config import _get_bool

    tls_on = bool(os.environ.get("GUBER_TLS_CERT")) or _get_bool(
        os.environ, "GUBER_TLS_AUTO", False
    )
    scheme = "https" if tls_on else "http"
    ca_file = os.environ.get("GUBER_TLS_CA", "")
    # only the main gateway enforces client auth; the status listener never
    # does — presenting the server pair (peers share it, tls.go:138-238)
    # makes the probe work against either
    probing_status = bool(os.environ.get("GUBER_STATUS_HTTP_ADDRESS"))
    cert_file = "" if probing_status else os.environ.get("GUBER_TLS_CERT", "")
    key_file = "" if probing_status else os.environ.get("GUBER_TLS_KEY", "")
    attempts_str = os.environ.get("GUBER_HTTP_RETRY_COUNT", "")
    try:
        attempts = int(attempts_str) if attempts_str else 1
    except ValueError:
        print(f"invalid GUBER_HTTP_RETRY_COUNT: {attempts_str!r}")
        return 1
    try:
        check(
            url, attempts, scheme=scheme, ca_file=ca_file,
            cert_file=cert_file, key_file=key_file,
            strict=_get_bool(os.environ, "GUBER_HEALTHCHECK_STRICT", False),
        )
    except NotHealthy as exc:
        print(exc)
        return 2
    except Exception as exc:  # noqa: BLE001
        print(exc)
        return 1
    print("is healthy")
    return 0


if __name__ == "__main__":
    sys.exit(main())
