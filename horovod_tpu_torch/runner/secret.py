"""Shared-secret request signing for the rendezvous KV store: the port's
copy of ``horovod_tpu/runner/secret.py`` (the same header and MAC, so the
port's KV client talks to the JAX package's launcher).

Parity: ``horovod/run/common/util/secret.py`` + the HMAC framing in
``run/common/util/network.py`` — the launcher generates a per-job secret,
ships it to workers through their environment (``HVD_SECRET_KEY``), and
every KV request carries an HMAC so a stray or malicious client on the
network cannot read or poison the rendezvous state.
"""

from __future__ import annotations

import hmac
import secrets as _secrets

ENV_VAR = "HVD_SECRET_KEY"
HEADER = "X-HVD-Auth"


def make_secret() -> str:
    return _secrets.token_hex(32)


def sign(secret: str, method: str, path: str, body: bytes = b"") -> str:
    """HMAC-SHA256 over the request essence (method, path, body)."""
    msg = method.encode() + b"\0" + path.encode() + b"\0" + (body or b"")
    return hmac.new(secret.encode(), msg, "sha256").hexdigest()


def verify(secret: str, method: str, path: str, body: bytes,
           signature: str) -> bool:
    if not signature:
        return False
    return hmac.compare_digest(sign(secret, method, path, body), signature)
