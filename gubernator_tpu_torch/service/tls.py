"""TLS subsystem: file-based certs, auto self-signed CA, client-auth modes
(the port of ``gubernator_tpu/service/tls.py``).

Mirrors the reference's tls.go scope (reference tls.go:50-520): server + client
credentials from PEM files, an AutoTLS mode that generates a self-signed CA and
server certificate in memory (reference tls.go:364-520), and client-auth
("require" = any client cert, "verify" = must chain to the CA — reference
TLSConfig.ClientAuth). Certificates are built with `cryptography`; gRPC takes
raw PEM bytes, aiohttp takes an ssl.SSLContext — both come from one CertBundle.

``cryptography`` is imported only when AutoTLS generates a certificate. Where
it is not installed, a config with ``tls_auto`` raises ConfigError naming the
package: the daemon never serves plaintext in place of the TLS it was asked
for.
"""

from __future__ import annotations

import datetime
import ipaddress
import ssl
import tempfile
from dataclasses import dataclass
from typing import Optional

import grpc

from gubernator_tpu_torch.config import ConfigError


@dataclass
class CertBundle:
    ca_pem: bytes
    cert_pem: bytes
    key_pem: bytes


_auto_cache: dict = {}


def generate_self_signed(hostnames=("localhost",)) -> CertBundle:
    """Self-signed CA + server cert (reference AutoTLS, tls.go:364-520).
    Raises ConfigError when the ``cryptography`` package is missing."""
    try:
        from cryptography import x509
        from cryptography.hazmat.primitives import hashes, serialization
        from cryptography.hazmat.primitives.asymmetric import rsa
        from cryptography.x509.oid import NameOID
    except ImportError as exc:
        raise ConfigError(
            "GUBER_TLS_AUTO needs the Python package `cryptography` to "
            "generate its certificates, and it is not installed; install it "
            "or give GUBER_TLS_CERT / GUBER_TLS_KEY files"
        ) from exc

    key = rsa.generate_private_key(public_exponent=65537, key_size=2048)
    ca_key = rsa.generate_private_key(public_exponent=65537, key_size=2048)
    now = datetime.datetime.now(datetime.timezone.utc)
    ca_name = x509.Name(
        [x509.NameAttribute(NameOID.COMMON_NAME, "gubernator-tpu auto CA")]
    )
    ca_cert = (
        x509.CertificateBuilder()
        .subject_name(ca_name)
        .issuer_name(ca_name)
        .public_key(ca_key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now - datetime.timedelta(minutes=5))
        .not_valid_after(now + datetime.timedelta(days=365))
        .add_extension(x509.BasicConstraints(ca=True, path_length=None), critical=True)
        .sign(ca_key, hashes.SHA256())
    )
    sans = []
    for h in hostnames:
        try:
            sans.append(x509.IPAddress(ipaddress.ip_address(h)))
        except ValueError:
            sans.append(x509.DNSName(h))
    sans.append(x509.IPAddress(ipaddress.ip_address("127.0.0.1")))
    cert = (
        x509.CertificateBuilder()
        .subject_name(
            x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, hostnames[0])])
        )
        .issuer_name(ca_name)
        .public_key(key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now - datetime.timedelta(minutes=5))
        .not_valid_after(now + datetime.timedelta(days=365))
        .add_extension(x509.SubjectAlternativeName(sans), critical=False)
        .sign(ca_key, hashes.SHA256())
    )
    return CertBundle(
        ca_pem=ca_cert.public_bytes(serialization.Encoding.PEM),
        cert_pem=cert.public_bytes(serialization.Encoding.PEM),
        key_pem=key.private_bytes(
            serialization.Encoding.PEM,
            serialization.PrivateFormat.TraditionalOpenSSL,
            serialization.NoEncryption(),
        ),
    )


def bundle_from_config(conf) -> CertBundle:
    """Resolve the cert bundle once per daemon: files when given, else AutoTLS
    (cached per advertise address so server and client sides agree)."""
    if conf.tls_cert_file and conf.tls_key_file:
        ca = b""
        if conf.tls_ca_file:
            with open(conf.tls_ca_file, "rb") as f:
                ca = f.read()
        with open(conf.tls_cert_file, "rb") as f:
            cert = f.read()
        with open(conf.tls_key_file, "rb") as f:
            key = f.read()
        return CertBundle(ca_pem=ca, cert_pem=cert, key_pem=key)
    host = conf.advertise_address.rsplit(":", 1)[0] or "localhost"
    if host not in _auto_cache:
        _auto_cache[host] = generate_self_signed((host,))
    return _auto_cache[host]


def server_credentials(conf) -> grpc.ServerCredentials:
    require = conf.tls_client_auth in ("require", "verify")
    if conf.tls_cert_file and conf.tls_key_file:
        # hot certificate reload (the keypairReloader analog, reference
        # tls.go:295-362): the per-handshake fetcher re-reads the PEM files
        # when their mtimes change, so rotated certs take effect without a
        # restart; a pair that fails validation (mid-rotation torn write,
        # mismatched key) keeps the last good pair serving, like the Go
        # reloader's LoadX509KeyPair guard
        state = {"mtimes": None, "config": None}

        def _maybe_load():
            """New ServerCertificateConfiguration when the files changed and
            validate, else None (the gRPC fetcher no-change contract)."""
            mtimes = cert_files_mtimes(conf)
            if mtimes is None:
                # unreadable files: loud at startup (initial load), treated
                # as no-change by the fetcher's guard afterwards
                raise FileNotFoundError("TLS cert/key files unreadable")
            if state["config"] is not None and mtimes == state["mtimes"]:
                return None
            b = bundle_from_config(conf)
            _validate_keypair(b)  # raises on torn/mismatched rotation
            state["config"] = grpc.ssl_server_certificate_configuration(
                [(b.key_pem, b.cert_pem)],
                root_certificates=b.ca_pem if require else None,
            )
            state["mtimes"] = mtimes
            return state["config"]

        initial = _maybe_load()

        def fetcher():
            try:
                return _maybe_load()
            except Exception:
                return None  # keep serving the last good pair

        return grpc.dynamic_ssl_server_credentials(
            initial, fetcher, require_client_authentication=require
        )
    b = bundle_from_config(conf)
    return grpc.ssl_server_credentials(
        [(b.key_pem, b.cert_pem)],
        root_certificates=b.ca_pem if require else None,
        require_client_auth=require,
    )


def _validate_keypair(b: CertBundle) -> None:
    """Reject torn/mismatched cert+key pairs before they reach handshakes."""
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    with tempfile.NamedTemporaryFile(suffix=".pem") as cf, tempfile.NamedTemporaryFile(
        suffix=".pem"
    ) as kf:
        cf.write(b.cert_pem)
        cf.flush()
        kf.write(b.key_pem)
        kf.flush()
        ctx.load_cert_chain(cf.name, kf.name)  # raises ssl.SSLError on mismatch


def cert_files_mtimes(conf):
    """Snapshot of the configured PEM files' mtimes (None when not
    file-based) — the daemon's rotation watcher keys on this."""
    import os

    if not (conf.tls_cert_file and conf.tls_key_file):
        return None
    paths = [conf.tls_cert_file, conf.tls_key_file] + (
        [conf.tls_ca_file] if conf.tls_ca_file else []
    )
    try:
        return tuple(os.path.getmtime(p) for p in paths)
    except OSError:
        return None


def client_credentials(conf) -> grpc.ChannelCredentials:
    """Peer-to-peer client credentials; with client-auth modes the peers
    present the same cert (the reference's peers share the server TLS setup,
    tls.go:138-238)."""
    b = bundle_from_config(conf)
    if conf.tls_client_auth in ("require", "verify"):
        return grpc.ssl_channel_credentials(
            root_certificates=b.ca_pem or None,
            private_key=b.key_pem,
            certificate_chain=b.cert_pem,
        )
    return grpc.ssl_channel_credentials(root_certificates=b.ca_pem or None)


def http_ssl_context(
    conf, require_client_auth: Optional[bool] = None
) -> Optional[ssl.SSLContext]:
    """Server-side ssl context for an HTTP listener. `require_client_auth`
    defaults to the daemon's client-auth mode; the status listener passes
    False so probes/scrapers work without certs (reference
    daemon.go:324-352)."""
    b = bundle_from_config(conf)
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    with tempfile.NamedTemporaryFile(suffix=".pem") as cf, tempfile.NamedTemporaryFile(
        suffix=".pem"
    ) as kf:
        cf.write(b.cert_pem)
        cf.flush()
        kf.write(b.key_pem)
        kf.flush()
        ctx.load_cert_chain(cf.name, kf.name)
    require = (
        conf.tls_client_auth in ("require", "verify")
        if require_client_auth is None
        else require_client_auth
    )
    if require:
        if not b.ca_pem:
            # never silently downgrade: the operator asked for client auth
            raise ValueError(
                "tls_client_auth is set but no CA is available to verify "
                "client certificates (set GUBER_TLS_CA or use GUBER_TLS_AUTO)"
            )
        ctx.verify_mode = ssl.CERT_REQUIRED
        ctx.load_verify_locations(cadata=b.ca_pem.decode())
    return ctx
