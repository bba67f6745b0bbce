"""Line-prefixed stdout IPC between job subprocesses and the session manager.

Wire-compatible with the reference protocol
(reference: src/utils/helper/connector.py:35-144): a child process prints
``<prefix> <json>`` lines on stdout; the parent multiplexes the child's
stdout/stderr and dispatches four message kinds:

  response-of-easevoice      final EaseVoiceResponse
  loss-of-easevoice          {"step": int, "loss": float, ...extras}
  log-of-easevoice           arbitrary log dict
  session-data-of-easevoice  progress payload for the session store

Anything unprefixed is passed through as plain output.
"""
from __future__ import annotations

import dataclasses
import json
import select
import subprocess
from typing import Any, Dict, Generator, Optional

from .response import EaseVoiceResponse

RESP_PREFIX = "response-of-easevoice"
LOSS_PREFIX = "loss-of-easevoice"
LOG_PREFIX = "log-of-easevoice"
SESSION_DATA_PREFIX = "session-data-of-easevoice"


class ConnectorDataType:
    RESP = "response"
    LOSS = "loss"
    LOG = "LOG"
    OTHER = "other"
    SESSION_DATA = "session_data"


@dataclasses.dataclass
class ConnectorDataLoss:
    step: int
    loss: float
    other: dict


@dataclasses.dataclass
class ConnectorData:
    dataType: str
    response: Optional[EaseVoiceResponse] = None
    loss: Optional[ConnectorDataLoss] = None
    log: Optional[dict] = None
    other: Optional[str] = None
    session_data: Optional[dict] = None


class MultiProcessOutputConnector:
    """Writer (child side) + select()-based reader (parent side).

    The reader keeps the last few non-protocol lines in ``tail`` so a child
    that dies without emitting a final response (crash, external SIGKILL)
    leaves a diagnosable trace for the session's failure message.
    """

    _TAIL_MAX = 20

    def __init__(self) -> None:
        self.tail: list[str] = []

    def _note_other(self, text: str) -> None:
        print(text)
        self.tail.append(text)
        if len(self.tail) > self._TAIL_MAX:
            del self.tail[: -self._TAIL_MAX]

    # ---- child side -------------------------------------------------------

    @staticmethod
    def _emit(prefix: str, payload: str) -> None:
        print(f"{prefix} {payload}", flush=True)

    def write_response(self, resp: EaseVoiceResponse) -> None:
        self._emit(RESP_PREFIX, json.dumps(resp.to_dict()))

    def write_loss(self, step: int, loss: Any,
                   other: Optional[Dict[str, Any]] = None) -> None:
        data: Dict[str, Any] = {"step": step, "loss": loss}
        if other:
            data.update(other)
        self._emit(LOSS_PREFIX, json.dumps(data))

    def write_log(self, log: dict) -> None:
        self._emit(LOG_PREFIX, json.dumps(log))

    def write_session_data(self, data: dict) -> None:
        self._emit(SESSION_DATA_PREFIX, json.dumps(data))

    # ---- parent side ------------------------------------------------------

    def read_data(self, process: subprocess.Popen
                  ) -> Generator[ConnectorData, None, None]:
        streams = [s for s in (process.stdout, process.stderr) if s]
        while True:
            ready, _, _ = select.select(streams, [], [], 0.1)
            for stream in ready:
                line = stream.readline()
                if not line:
                    continue
                if isinstance(line, bytes):
                    line = line.decode("utf-8", errors="replace")
                parsed = self.parse_line(line.strip())
                if parsed is None:
                    continue
                if parsed.dataType == ConnectorDataType.OTHER:
                    if parsed.other:
                        self._note_other(parsed.other)
                else:
                    yield parsed

            if process.poll() is not None:
                for stream in streams:
                    try:
                        remaining = stream.read()
                    except ValueError:
                        continue
                    if not remaining:
                        continue
                    if isinstance(remaining, bytes):
                        remaining = remaining.decode("utf-8", errors="replace")
                    for raw in remaining.splitlines():
                        parsed = self.parse_line(raw.strip())
                        if parsed is None:
                            continue
                        if parsed.dataType == ConnectorDataType.OTHER:
                            if parsed.other:
                                self._note_other(parsed.other)
                        else:
                            yield parsed
                break
        process.wait()

    @staticmethod
    def parse_line(line: str) -> Optional[ConnectorData]:
        try:
            if line.startswith(RESP_PREFIX):
                data = json.loads(line[len(RESP_PREFIX):].strip())
                return ConnectorData(
                    dataType=ConnectorDataType.RESP,
                    response=EaseVoiceResponse.from_dict(data))
            if line.startswith(LOSS_PREFIX):
                data = json.loads(line[len(LOSS_PREFIX):].strip())
                step = data.pop("step")
                loss = data.pop("loss")
                return ConnectorData(
                    dataType=ConnectorDataType.LOSS,
                    loss=ConnectorDataLoss(step, loss, data))
            if line.startswith(LOG_PREFIX):
                return ConnectorData(
                    dataType=ConnectorDataType.LOG,
                    log=json.loads(line[len(LOG_PREFIX):].strip()))
            if line.startswith(SESSION_DATA_PREFIX):
                return ConnectorData(
                    dataType=ConnectorDataType.SESSION_DATA,
                    session_data=json.loads(
                        line[len(SESSION_DATA_PREFIX):].strip()))
            return ConnectorData(dataType=ConnectorDataType.OTHER, other=line)
        except Exception as e:  # malformed payload: report, keep reading
            print(f"meet error when parse stdout: {e}, input: <{line}>")
            return None
