"""Status / Result error model.

Re-design of the Arrow ``Status``/``Result`` currency used across
every layer of the reference (see reference ``src/include/util.h:155-207``,
which bridges ``arrow::StatusCode`` to negative ints so hot functions can
return plain ints). We keep the same two ideas:

* rich ``Status`` objects with a code + message for the public API, and
* a stable negative-int encoding (``Status.to_int`` / ``Status.from_int``)
  so native (C++) hot paths and async workers can report errors without
  constructing Python objects.

Unlike the reference we never ``rte_exit`` from library code: fatal paths
raise ``StatusError`` (or return a failed ``Result``) and leave process
teardown to the caller.

A copy of ``bitar_tpu/status.py``: the port keeps the same codes so that
per-block statuses compare equal across the two packages.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Callable, Generic, TypeVar

T = TypeVar("T")


class StatusCode(enum.IntEnum):
    """Mirrors the arrow::StatusCode values the reference relies on.

    The int values form the stable native bridge: native code returns
    ``-int(code)`` on failure, ``>= 0`` on success (reference
    ``util.h:157-175`` encodes ``-static_cast<int>(status_code)``).
    """

    OK = 0
    OUT_OF_MEMORY = 1
    KEY_ERROR = 2
    TYPE_ERROR = 3
    INVALID = 4
    IO_ERROR = 5
    CAPACITY_ERROR = 6
    INDEX_ERROR = 7
    CANCELLED = 8
    UNKNOWN_ERROR = 9
    NOT_IMPLEMENTED = 10
    SERIALIZATION_ERROR = 11


@dataclass(frozen=True, slots=True)
class Status:
    """An operation outcome: a code plus a human-readable message."""

    code: StatusCode = StatusCode.OK
    message: str = ""

    # -- constructors ------------------------------------------------------
    @staticmethod
    def OK() -> "Status":  # noqa: N802 - mirrors arrow spelling
        return _OK

    @staticmethod
    def Invalid(msg: str) -> "Status":  # noqa: N802
        return Status(StatusCode.INVALID, msg)

    @staticmethod
    def IOError(msg: str) -> "Status":  # noqa: N802
        return Status(StatusCode.IO_ERROR, msg)

    @staticmethod
    def OutOfMemory(msg: str) -> "Status":  # noqa: N802
        return Status(StatusCode.OUT_OF_MEMORY, msg)

    @staticmethod
    def CapacityError(msg: str) -> "Status":  # noqa: N802
        return Status(StatusCode.CAPACITY_ERROR, msg)

    @staticmethod
    def NotImplemented(msg: str) -> "Status":  # noqa: N802
        return Status(StatusCode.NOT_IMPLEMENTED, msg)

    @staticmethod
    def UnknownError(msg: str) -> "Status":  # noqa: N802
        return Status(StatusCode.UNKNOWN_ERROR, msg)

    @staticmethod
    def Cancelled(msg: str) -> "Status":  # noqa: N802
        return Status(StatusCode.CANCELLED, msg)

    # -- predicates --------------------------------------------------------
    def ok(self) -> bool:
        return self.code == StatusCode.OK

    # -- native int bridge (reference util.h:157-207) ----------------------
    def to_int(self) -> int:
        """OK -> 0; failure -> negative code (stable across the C ABI)."""
        return 0 if self.ok() else -int(self.code)

    @staticmethod
    def from_int(value: int, message: str = "") -> "Status":
        if value >= 0:
            return _OK
        try:
            code = StatusCode(-value)
        except ValueError:
            code = StatusCode.UNKNOWN_ERROR
        return Status(code, message)

    # -- ergonomics --------------------------------------------------------
    def raise_if_error(self) -> None:
        if not self.ok():
            raise StatusError(self)

    def with_context(self, prefix: str) -> "Status":
        if self.ok():
            return self
        return Status(self.code, f"{prefix}: {self.message}")

    def __str__(self) -> str:
        return "OK" if self.ok() else f"{self.code.name}: {self.message}"


_OK = Status(StatusCode.OK, "")


class StatusError(RuntimeError):
    """Raised when a failing Status is escalated to an exception."""

    def __init__(self, status: Status):
        super().__init__(str(status))
        self.status = status


class Result(Generic[T]):
    """A value-or-Status, mirroring arrow::Result.

    Matches the reference's
    ``std::function<int(..., arrow::Result<...>)`` callback contract
    (reference ``src/include/util.h:49-101``).
    """

    __slots__ = ("_value", "_status")

    def __init__(self, value: T | None = None, status: Status | None = None):
        if status is not None and not status.ok():
            self._status = status
            self._value = None
        else:
            self._status = _OK
            self._value = value

    @staticmethod
    def ok(value: T) -> "Result[T]":
        return Result(value=value)

    @staticmethod
    def error(status: Status) -> "Result[T]":
        assert not status.ok()
        return Result(status=status)

    @property
    def status(self) -> Status:
        return self._status

    def is_ok(self) -> bool:
        return self._status.ok()

    def value(self) -> T:
        """Return the value, raising StatusError when the result failed."""
        self._status.raise_if_error()
        return self._value  # type: ignore[return-value]

    def value_or_raise(self) -> T:
        return self.value()

    def map(self, fn: Callable[[T], "T"]) -> "Result[T]":
        if not self.is_ok():
            return self
        return Result.ok(fn(self._value))  # type: ignore[arg-type]

    def __repr__(self) -> str:
        if self.is_ok():
            return f"Result.ok({self._value!r})"
        return f"Result.error({self._status})"
