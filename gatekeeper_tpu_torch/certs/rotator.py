"""Self-signed CA + serving-cert rotation (reference
vendor/github.com/open-policy-agent/cert-controller/pkg/rotator/).

The reference generates a CA and server certificate, stores them in the
webhook Secret, injects the CA bundle into the
ValidatingWebhookConfiguration, refreshes before expiry, and gates
controller startup on cert readiness (main.go:158-178; setupControllers
blocks on the IsReady channel at main.go:219-220).  Same protocol here:
`CertRotator.ensure_certs()` creates/refreshes, `is_ready` is the startup
gate, `start()` spins the periodic refresh loop.
"""

from __future__ import annotations

import datetime
import threading
from typing import List, Optional, Tuple

from cryptography import x509
from cryptography.hazmat.primitives import hashes, serialization
from cryptography.hazmat.primitives.asymmetric import rsa
from cryptography.x509.oid import NameOID

from .. import logging as gklog
from ..kube.inmem import InMemoryKube, NotFound
from ..util import join_thread

log = gklog.get("cert-rotation")

SECRET_GVK = ("", "v1", "Secret")
VWC_GVK = ("admissionregistration.k8s.io", "v1", "ValidatingWebhookConfiguration")

CA_VALIDITY = datetime.timedelta(days=365 * 10)
CERT_VALIDITY = datetime.timedelta(days=90)
# refresh when less than this much validity remains (rotator refreshes
# certs well before expiry)
REFRESH_MARGIN = datetime.timedelta(days=30)


def _utcnow() -> datetime.datetime:
    return datetime.datetime.now(datetime.timezone.utc)


def _key() -> rsa.RSAPrivateKey:
    return rsa.generate_private_key(public_exponent=65537, key_size=2048)


def _pem_cert(cert: x509.Certificate) -> bytes:
    return cert.public_bytes(serialization.Encoding.PEM)


def _pem_key(key: rsa.RSAPrivateKey) -> bytes:
    return key.private_bytes(
        serialization.Encoding.PEM,
        serialization.PrivateFormat.TraditionalOpenSSL,
        serialization.NoEncryption(),
    )


def generate_ca(common_name: str = "gatekeeper-ca") -> Tuple[bytes, bytes]:
    """-> (ca_cert_pem, ca_key_pem)."""
    key = _key()
    name = x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, common_name)])
    now = _utcnow()
    cert = (
        x509.CertificateBuilder()
        .subject_name(name)
        .issuer_name(name)
        .public_key(key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now - datetime.timedelta(minutes=5))
        .not_valid_after(now + CA_VALIDITY)
        .add_extension(x509.BasicConstraints(ca=True, path_length=None),
                       critical=True)
        .sign(key, hashes.SHA256())
    )
    return _pem_cert(cert), _pem_key(key)


def generate_server_cert(
    ca_cert_pem: bytes,
    ca_key_pem: bytes,
    dns_names: List[str],
) -> Tuple[bytes, bytes]:
    """-> (server_cert_pem, server_key_pem) signed by the CA."""
    ca_cert = x509.load_pem_x509_certificate(ca_cert_pem)
    ca_key = serialization.load_pem_private_key(ca_key_pem, password=None)
    key = _key()
    now = _utcnow()
    cert = (
        x509.CertificateBuilder()
        .subject_name(
            x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, dns_names[0])])
        )
        .issuer_name(ca_cert.subject)
        .public_key(key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now - datetime.timedelta(minutes=5))
        .not_valid_after(now + CERT_VALIDITY)
        .add_extension(
            x509.SubjectAlternativeName(
                [x509.DNSName(n) for n in dns_names]
            ),
            critical=False,
        )
        .sign(ca_key, hashes.SHA256())
    )
    return _pem_cert(cert), _pem_key(key)


def cert_expiry(cert_pem: bytes) -> datetime.datetime:
    return x509.load_pem_x509_certificate(cert_pem).not_valid_after_utc


class CertRotator:
    """Maintains the webhook Secret and the VWC caBundle.

    secret data keys follow the reference rotator: ca.crt / ca.key /
    tls.crt / tls.key.
    """

    def __init__(
        self,
        kube: InMemoryKube,
        secret_name: str = "gatekeeper-webhook-server-cert",
        namespace: str = "gatekeeper-system",
        service_name: str = "gatekeeper-webhook-service",
        vwc_names: Optional[List[str]] = None,
        check_interval_s: float = 3600.0,
    ):
        self.kube = kube
        self.secret_name = secret_name
        self.namespace = namespace
        self.dns_names = [
            service_name,
            f"{service_name}.{namespace}",
            f"{service_name}.{namespace}.svc",
        ]
        self.vwc_names = vwc_names or ["gatekeeper-validating-webhook-configuration"]
        self.check_interval_s = check_interval_s
        # called with the new secret after a refresh (serving-cert hot
        # reload hook for the webhook server)
        self.on_refresh = None
        self.is_ready = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ---- core --------------------------------------------------------------

    def _load_secret(self) -> Optional[dict]:
        try:
            return self.kube.get(SECRET_GVK, self.secret_name, self.namespace)
        except NotFound:
            return None

    @staticmethod
    def _secret_data(secret: Optional[dict]) -> dict:
        """Normalized key->str cert material.  A real API server returns
        base64 under `data` (stringData is write-only); the in-memory store
        echoes stringData.  Accept both."""
        import base64

        if not secret:
            return {}
        out = {}
        for k, v in (secret.get("data") or {}).items():
            try:
                out[k] = base64.b64decode(v).decode()
            except (TypeError, ValueError):
                # not base64 / not utf-8: skip the one bad key, keep the
                # rest of the secret usable (UnicodeDecodeError and
                # binascii.Error are ValueError subclasses)
                continue
        out.update(secret.get("stringData") or {})
        return out

    @staticmethod
    def _pem_valid(pem: Optional[str], margin: datetime.timedelta) -> bool:
        if not pem:
            return False
        try:
            return cert_expiry(pem.encode()) - _utcnow() > margin
        except Exception:
            return False

    def ensure_certs(self) -> dict:
        """Create or refresh the cert Secret; inject the CA bundle; signal
        readiness.  Returns the secret.

        Refresh keeps the existing CA whenever it is still valid and only
        re-signs the serving cert — minting a new CA would break TLS for
        every webhook replica still serving the old cert until all of them
        reload (the apiserver validates against the VWC caBundle)."""
        secret = self._load_secret()
        data = self._secret_data(secret)
        ca_ok = (
            self._pem_valid(data.get("ca.crt"), REFRESH_MARGIN)
            and data.get("ca.key")
        )
        tls_ok = (
            ca_ok
            and self._pem_valid(data.get("tls.crt"), REFRESH_MARGIN)
            and bool(data.get("tls.key"))
        )
        if not tls_ok:
            if ca_ok:
                ca_crt = data["ca.crt"].encode()
                ca_key = data["ca.key"].encode()
            else:
                ca_crt, ca_key = generate_ca()
            tls_crt, tls_key = generate_server_cert(
                ca_crt, ca_key, self.dns_names
            )
            secret = {
                "apiVersion": "v1",
                "kind": "Secret",
                "metadata": {
                    "name": self.secret_name,
                    "namespace": self.namespace,
                },
                "stringData": {
                    "ca.crt": ca_crt.decode()
                    if isinstance(ca_crt, bytes) else ca_crt,
                    "ca.key": ca_key.decode()
                    if isinstance(ca_key, bytes) else ca_key,
                    "tls.crt": tls_crt.decode(),
                    "tls.key": tls_key.decode(),
                },
            }
            self.kube.apply(secret)
            log.info(
                "generated new webhook certificates (ca %s)",
                "reused" if ca_ok else "minted",
            )
            if self.on_refresh is not None:
                try:
                    self.on_refresh(secret)
                except Exception:
                    log.exception("cert refresh hook failed")
        self._inject_ca_bundle(secret)
        self.is_ready.set()
        return secret

    def _inject_ca_bundle(self, secret: dict):
        """Write caBundle into every webhook clientConfig of the managed
        ValidatingWebhookConfigurations."""
        import base64

        ca = self._secret_data(secret)["ca.crt"].encode()
        bundle = base64.b64encode(ca).decode()
        for name in self.vwc_names:
            try:
                vwc = self.kube.get(VWC_GVK, name)
            except NotFound:
                continue
            changed = False
            for wh in vwc.get("webhooks") or []:
                cc = wh.setdefault("clientConfig", {})
                if cc.get("caBundle") != bundle:
                    cc["caBundle"] = bundle
                    changed = True
            if changed:
                self.kube.update(vwc)

    def write_cert_files(self, cert_dir: str,
                         secret: Optional[dict] = None) -> Tuple[str, str]:
        """Materialize tls.crt/tls.key for the HTTPS listener; returns
        (certfile, keyfile) paths.  Key material is 0600 in a 0700 dir."""
        import os

        data = self._secret_data(secret or self.ensure_certs())
        os.makedirs(cert_dir, mode=0o700, exist_ok=True)
        os.chmod(cert_dir, 0o700)
        certfile = os.path.join(cert_dir, "tls.crt")
        keyfile = os.path.join(cert_dir, "tls.key")
        with open(certfile, "w") as f:
            f.write(data["tls.crt"])
        fd = os.open(keyfile, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
        with os.fdopen(fd, "w") as f:
            f.write(data["tls.key"])
        os.chmod(keyfile, 0o600)
        return certfile, keyfile

    # ---- loop --------------------------------------------------------------

    def start(self):
        if not self.is_ready.is_set():
            self.ensure_certs()
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="cert-rotator", daemon=True
        )
        self._thread.start()

    def _run(self):
        while not self._stop.wait(timeout=self.check_interval_s):
            try:
                self.ensure_certs()
            except Exception:
                log.exception("cert refresh failed")

    def stop(self):
        self._stop.set()
        if self._thread:
            join_thread(self._thread, 2.0, "cert rotator loop")
            self._thread = None
