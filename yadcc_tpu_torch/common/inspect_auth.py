"""HTTP Basic-auth gate for /inspect/* endpoints, parity with reference
yadcc/common/inspect_auth.h:23-31 (--inspect_credential)."""

from __future__ import annotations

import base64
import hmac
from typing import Optional


class InspectAuth:
    def __init__(self, credential: str = ""):
        """credential: "user:password"; empty disables auth."""
        self._credential = credential

    def check(self, authorization_header: Optional[str]) -> bool:
        if not self._credential:
            return True
        if not authorization_header:
            return False
        parts = authorization_header.split(None, 1)
        if len(parts) != 2 or parts[0].lower() != "basic":
            return False
        try:
            decoded = base64.b64decode(parts[1]).decode()
        except Exception:
            return False
        return hmac.compare_digest(decoded, self._credential)
