"""Response envelope shared by REST handlers, services and CLI subprocesses.

Wire-compatible with the reference envelope
(reference: src/utils/response/__init__.py:17-31): every start/stop endpoint
and every subprocess final message serializes to
``{"status": "success"|"failed", "message": str, "data": dict|None,
"uuid": str|None}``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Literal, Optional

ResponseStatusType = Literal["success", "failed"]


class ResponseStatus:
    SUCCESS: ResponseStatusType = "success"
    FAILED: ResponseStatusType = "failed"


@dataclasses.dataclass
class EaseVoiceResponse:
    status: ResponseStatusType
    message: str
    data: Optional[dict] = None
    uuid: Optional[str] = None

    def to_dict(self) -> dict[str, Any]:
        return {
            "status": self.status,
            "message": self.message,
            "data": self.data,
            "uuid": self.uuid,
        }

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "EaseVoiceResponse":
        return cls(
            status=d.get("status", ResponseStatus.FAILED),
            message=d.get("message", ""),
            data=d.get("data"),
            uuid=d.get("uuid"),
        )

    @property
    def ok(self) -> bool:
        return self.status == ResponseStatus.SUCCESS

    def __str__(self) -> str:  # same printable form as the reference
        return str(self.to_dict())
