"""API middleware primitives: JWT auth + per-IP token-bucket rate limiting.

Parity with the reference's middleware (reference: pkg/api/middleware.go):
HMAC-SHA256 JWT with Bearer parsing (middleware.go:15-70) — implemented
directly on hmac/hashlib since the environment ships no JWT library — and a
per-client-IP token bucket with idle eviction (middleware.go:79-139).

A copy of ``quiver_tpu/api/auth.py`` (pure stdlib): the port imports
nothing of ``quiver_tpu``, whose package ``__init__`` imports jax.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import threading
import time
from typing import Optional


def _b64url(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode()


def _b64url_decode(s: str) -> bytes:
    return base64.urlsafe_b64decode(s + "=" * (-len(s) % 4))


def jwt_encode(payload: dict, secret: str) -> str:
    """HS256 JWT (for tests/clients and the CLI's token helper)."""
    header = {"alg": "HS256", "typ": "JWT"}
    signing = f"{_b64url(json.dumps(header).encode())}.{_b64url(json.dumps(payload).encode())}"
    sig = hmac.new(secret.encode(), signing.encode(), hashlib.sha256).digest()
    return f"{signing}.{_b64url(sig)}"


def jwt_decode(token: str, secret: str) -> dict:
    """Verify signature + exp; raises ValueError on any failure."""
    try:
        header_b64, payload_b64, sig_b64 = token.split(".")
    except ValueError:
        raise ValueError("malformed token")
    signing = f"{header_b64}.{payload_b64}"
    want = hmac.new(secret.encode(), signing.encode(), hashlib.sha256).digest()
    if not hmac.compare_digest(want, _b64url_decode(sig_b64)):
        raise ValueError("invalid signature")
    header = json.loads(_b64url_decode(header_b64))
    if header.get("alg") != "HS256":
        raise ValueError("unsupported algorithm")
    payload = json.loads(_b64url_decode(payload_b64))
    exp = payload.get("exp")
    if exp is not None and time.time() > float(exp):
        raise ValueError("token expired")
    return payload


def parse_bearer(header_value: Optional[str]) -> str:
    """Extract the token from an Authorization header (middleware.go:30-45)."""
    if not header_value:
        raise ValueError("missing Authorization header")
    parts = header_value.split()
    if len(parts) != 2 or parts[0].lower() != "bearer":
        raise ValueError("Authorization header must be 'Bearer <token>'")
    return parts[1]


class _Bucket:
    __slots__ = ("tokens", "last_fill", "last_seen")

    def __init__(self, capacity: float):
        self.tokens = capacity
        self.last_fill = time.monotonic()
        self.last_seen = self.last_fill


class RateLimiter:
    """Per-client token bucket with idle eviction (middleware.go:79-139).

    capacity tokens, refilled at rate/s; clients idle > idle_evict_s are
    dropped so the table stays bounded.
    """

    def __init__(self, rate: float = 100.0, capacity: float = 200.0,
                 idle_evict_s: float = 180.0):
        self.rate = rate
        self.capacity = capacity
        self.idle_evict_s = idle_evict_s
        self._buckets: dict[str, _Bucket] = {}
        self._lock = threading.Lock()
        self._last_sweep = time.monotonic()

    def allow(self, client: str) -> bool:
        now = time.monotonic()
        with self._lock:
            if now - self._last_sweep > self.idle_evict_s:
                self._last_sweep = now
                dead = [
                    k for k, b in self._buckets.items()
                    if now - b.last_seen > self.idle_evict_s
                ]
                for k in dead:
                    del self._buckets[k]
            b = self._buckets.get(client)
            if b is None:
                b = _Bucket(self.capacity)
                self._buckets[client] = b
            b.tokens = min(
                self.capacity, b.tokens + (now - b.last_fill) * self.rate
            )
            b.last_fill = now
            b.last_seen = now
            if b.tokens >= 1.0:
                b.tokens -= 1.0
                return True
            return False
