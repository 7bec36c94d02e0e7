"""Enforce-style error checking (counterpart of ``paddle_tpu.core.errors``,
itself the analog of the reference's ``PADDLE_ENFORCE*`` macros)."""

from __future__ import annotations

from typing import Any


class EnforceError(RuntimeError):
    """Framework invariant violation (PADDLE_ENFORCE analog)."""


class NotFoundError(EnforceError, KeyError):
    """A named variable/parameter was not found."""


class NotYetPorted(EnforceError, NotImplementedError):
    """A feature of ``paddle_tpu`` that this port does not carry yet
    (ROADMAP.md lists each one with the slice that brings it)."""


def enforce(cond: Any, msg: str = "", *args: Any) -> None:
    """Raise :class:`EnforceError` unless ``cond`` is truthy."""
    if not cond:
        raise EnforceError(msg % args if args else msg)
