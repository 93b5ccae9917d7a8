"""Typed serving errors: every error carries a stable ``code`` that
clients branch on instead of parsing messages."""

from __future__ import annotations


class ServingError(Exception):
    """Base of the serving pipeline's typed error contract."""

    code = "internal"

    def __init__(self, message: str, code: str = None):
        super().__init__(message)
        if code is not None:
            self.code = code


class DeadlineExpired(ServingError):
    """The record's client TTL elapsed before (or while) the pipeline
    could serve it — the work was shed, not attempted and failed."""

    code = "expired"
