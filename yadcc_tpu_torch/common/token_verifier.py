"""Set-membership token auth, parity with reference
yadcc/common/token_verifier.h:32-59.  Tokens are opaque strings; an empty
verifier accepts everything (matching the reference's permissive default
when no tokens are configured)."""

from __future__ import annotations

import secrets
from typing import Iterable, Set


class TokenVerifier:
    def __init__(self, tokens: Iterable[str] = ()):
        self._tokens: Set[str] = {t for t in tokens if t}

    def verify(self, token: str) -> bool:
        if not self._tokens:
            return True
        return token in self._tokens

    @property
    def empty(self) -> bool:
        return not self._tokens


def make_token_verifier_from_flag(flag_value: str) -> TokenVerifier:
    """Comma-separated token list, as in --acceptable_user_tokens."""
    return TokenVerifier(t.strip() for t in flag_value.split(",") if t.strip())


def generate_token(nbytes: int = 16) -> str:
    """Random token, used for the scheduler's hourly-rotating
    serving-daemon token (reference scheduler_service_impl.cc:46-51)."""
    return secrets.token_hex(nbytes)
