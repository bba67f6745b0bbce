"""Session manager: single-task guard, session registry, subprocess jobs
(JAX: service/session.py), with its behaviour and JSON shapes:

* singleton; one running task at a time (409 upstream);
* ring buffer of MAX_SESSIONS=10 sessions, never evicting the running one;
* per-session loss history capped at MAX_LOSS=50;
* monitor metrics injected into reads;
* heavy jobs run as ``python -m easevoice_trainer_tpu_torch.cmd.<task> -c
  <json>`` subprocesses whose stdout streams the connector protocol;
* stop = SIGTERM the whole process tree.

Differences from the JAX module, on purpose:

* no ``psutil``: the CPU meter is psutil's ``cpu_percent()`` computed from
  ``/proc/stat`` deltas between calls, and the process tree is found from
  the parent pid of every ``/proc/<n>/stat``;
* the manager's ``device`` (the server's) goes into every subprocess
  task's params; a request's own ``device`` never overrides it;
* on a CUDA manager ``monitor_metrics`` reads the card's name and its
  used memory from ``torch.cuda.mem_get_info`` (the whole card, so a
  training child's memory shows), and an error there is raised;
* a task stopped by the user reads ``Completed`` with "Task stopped by
  user.": the reader of a child that the stop killed does not fail the
  session afterwards, as the JAX reader does when it notices the death.
"""
from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import tempfile
import threading
from dataclasses import asdict, is_dataclass
from datetime import datetime
from enum import Enum
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

from ..utils.connector import (
    ConnectorDataLoss, ConnectorDataType, MultiProcessOutputConnector)
from ..utils.logger import logger
from ..utils.response import EaseVoiceResponse, ResponseStatus


class Status(Enum):
    RUNNING = "Running"
    COMPLETED = "Completed"
    FAILED = "Failed"


class SessionConflictError(RuntimeError):
    """Raised when a second task is submitted while one is running."""


def _cpu_times() -> tuple:
    """(busy, total) jiffies of all CPUs from /proc/stat, as psutil counts
    them: guest time is already in user time, idle includes iowait."""
    with open("/proc/stat") as f:
        fields = [int(v) for v in f.readline().split()[1:]]
    total = sum(fields[:8])          # user .. steal; guest(_nice) excluded
    idle = fields[3] + (fields[4] if len(fields) > 4 else 0)
    return total - idle, total


class SessionManager:
    _instance: Optional["SessionManager"] = None
    _lock = threading.Lock()
    MAX_SESSIONS = 10
    MAX_LOSS = 50

    def __new__(cls):
        if cls._instance is None:
            with cls._lock:
                if cls._instance is None:
                    inst = super().__new__(cls)
                    inst.session_list = {}
                    inst.session_uuids = []
                    inst.session_subprocess = {}
                    inst.exist_session = None
                    inst.last_runned_session = None
                    inst.device = "cuda"
                    inst._state_lock = threading.RLock()
                    inst._cpu_last = _cpu_times()  # prime the sampler
                    cls._instance = inst
        return cls._instance

    @classmethod
    def reset(cls):
        """Testing hook."""
        with cls._lock:
            cls._instance = None

    # ---- lifecycle --------------------------------------------------------

    def start_session(self, uuid: str, task_name: str,
                      request: Optional[Any] = None) -> None:
        with self._state_lock:
            if self.exist_session is not None:
                raise SessionConflictError(
                    "A task is already running. Cannot submit another task!")
            if is_dataclass(request):
                request = asdict(request)
            self.session_list[uuid] = {
                "uuid": uuid,
                "task_name": task_name,
                "request": request,
                "status": Status.RUNNING,
                "created_at": datetime.now().strftime("%Y-%m-%d %H:%M:%S"),
                "error": None,
            }
            self.session_uuids.append(uuid)
            self._evict_over_limit()
            self.exist_session = uuid

    def _evict_over_limit(self) -> None:
        while len(self.session_uuids) > self.MAX_SESSIONS:
            if (self.exist_session is not None
                    and self.exist_session == self.session_uuids[0]):
                uuid = self.session_uuids.pop(1)
            else:
                uuid = self.session_uuids.pop(0)
            self.session_list.pop(uuid, None)

    def end_session_with_response(self, uuid: str,
                                  result: EaseVoiceResponse) -> None:
        with self._state_lock:
            session = self.session_list.get(uuid)
            if session is not None:
                if result.status == ResponseStatus.SUCCESS:
                    session["status"] = Status.COMPLETED
                else:
                    session["status"] = Status.FAILED
                    session["error"] = result.message
                session["message"] = result.message
                if result.data:
                    session["data"] = result.data
            self._clear_running(uuid)

    def fail_session(self, uuid: str, error: str) -> None:
        with self._state_lock:
            session = self.session_list.get(uuid)
            if session is not None:
                session["status"] = Status.FAILED
                session["error"] = error
            self._clear_running(uuid)

    def _clear_running(self, uuid: str) -> None:
        if self.exist_session == uuid:
            self.exist_session = None
            self.last_runned_session = uuid

    # ---- updates ----------------------------------------------------------

    def update_session_info(self, uuid: str, info: Dict[str, Any]) -> None:
        with self._state_lock:
            if uuid not in self.session_list:
                raise RuntimeError("No active task to update session info!")
            self.session_list[uuid].update(info)

    def update_session_loss(self, uuid: str, loss: ConnectorDataLoss) -> None:
        with self._state_lock:
            if uuid not in self.session_list:
                raise RuntimeError("No active task to update session loss!")
            losses = self.session_list[uuid].setdefault("losses", [])
            losses.append(asdict(loss))
            if len(losses) > self.MAX_LOSS:
                losses.pop(0)

    # ---- reads ------------------------------------------------------------

    def get_session_info(self) -> Dict[str, Any]:
        with self._state_lock:
            out = dict(self.session_list)
        out.update(self._monitor_metrics())
        return out

    def get_current_session_info(self) -> Dict[str, Any]:
        with self._state_lock:
            uuid = self.exist_session or self.last_runned_session
            if uuid is None:
                return {}
            session = dict(self.session_list.get(uuid, {}))
        metrics = self._monitor_metrics()
        metrics.update(session)
        return metrics

    def exist_running_session(self) -> bool:
        return self.exist_session is not None

    # ---- subprocess registry ----------------------------------------------

    def add_session_subprocess(self, uuid: str, pid: int) -> None:
        self.session_subprocess[uuid] = pid

    def remove_session_subprocess(self, uuid: str) -> None:
        self.session_subprocess.pop(uuid, None)

    def get_session_subprocess(self, uuid: str) -> Optional[int]:
        return self.session_subprocess.get(uuid)

    # ---- monitoring -------------------------------------------------------

    def cpu_percent(self) -> float:
        """System-wide CPU use since the last call, in percent with one
        decimal (psutil's ``cpu_percent()`` with no interval)."""
        busy, total = _cpu_times()
        with self._state_lock:
            busy0, total0 = self._cpu_last
            self._cpu_last = (busy, total)
        if total <= total0:
            return 0.0
        return round(min(100.0, max(0.0, (busy - busy0) / (total - total0)
                                    * 100)), 1)

    def _monitor_metrics(self) -> Dict[str, Any]:
        metrics: Dict[str, Any] = {
            "cpu_percentage": f"{self.cpu_percent()}%",
        }
        if self.device.startswith("cuda"):
            import torch

            dev = torch.device(self.device)
            metrics["accelerator"] = torch.cuda.get_device_name(dev)
            free, total = torch.cuda.mem_get_info(dev)
            metrics["memory_allocated_percentage"] = (
                f"{(total - free) / total * 100:.2f}%")
        else:
            metrics["accelerator"] = self.device
        return {"monitor_metrics": metrics}


session_manager = SessionManager()


def _manager() -> SessionManager:
    """Resolve the current singleton (robust to SessionManager.reset())."""
    return SessionManager()


def backtask_with_session_guard(uuid: str, task_name: str,
                                request_params: Any, func: Callable,
                                **kwargs) -> None:
    """Run ``func`` on a daemon thread under the single-task guard.

    Raises SessionConflictError (mapped to HTTP 409 by the REST layer) if a
    task is already running.
    """
    _manager().start_session(uuid, task_name, request_params)

    def wrapper():
        try:
            func(**kwargs)
        except Exception as e:
            logger.exception("task %s failed", task_name)
            _manager().fail_session(uuid, str(e))
        finally:
            _manager().remove_session_subprocess(uuid)

    threading.Thread(target=wrapper, daemon=True).start()


def task_params(request: Any) -> Dict[str, Any]:
    """The params a subprocess task is given: the request's fields with the
    manager's device in place of any ``device`` the request names."""
    params = asdict(request) if is_dataclass(request) else dict(request)
    params["device"] = _manager().device
    return params


def start_task_with_subprocess(uid: str, cmd_module: str, request: Any) -> None:
    """Serialize params to a temp JSON file and run the cmd module.

    The child is ``python -m easevoice_trainer_tpu_torch.cmd.<name> -c
    <file>`` on the manager's device; its stdout is consumed with the
    connector protocol and routed into the session.
    """
    with tempfile.NamedTemporaryFile(mode="w+", encoding="utf-8",
                                     suffix=".json", delete=False) as fp:
        json.dump(task_params(request), fp)
        temp_file_path = fp.name

    # The child resolves the package by import, not cwd: prepend the package
    # parent dir to PYTHONPATH so spawning works from any working directory.
    env = dict(os.environ)
    pkg_parent = str(Path(__file__).resolve().parents[2])
    env["PYTHONPATH"] = (pkg_parent + os.pathsep + env["PYTHONPATH"]
                         if env.get("PYTHONPATH") else pkg_parent)
    proc = subprocess.Popen(
        [sys.executable, "-m",
         f"easevoice_trainer_tpu_torch.cmd.{cmd_module}",
         "-c", temp_file_path],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env)
    _manager().add_session_subprocess(uid, proc.pid)
    connector = MultiProcessOutputConnector()
    saw_response = False
    for data in connector.read_data(proc):
        if data.dataType == ConnectorDataType.RESP:
            saw_response = True
            _manager().end_session_with_response(uid, data.response)
        elif data.dataType == ConnectorDataType.SESSION_DATA:
            _manager().update_session_info(uid, data.session_data)
        elif data.dataType == ConnectorDataType.LOSS:
            _manager().update_session_loss(uid, data.loss)
    # a child that dies without its final response (crash, external SIGKILL,
    # interpreter abort) must not leave the session "Running" forever; a
    # child that a stop killed is no longer registered, and its session
    # keeps the stop's response
    if not saw_response and _manager().get_session_subprocess(uid):
        rc = proc.poll()
        tail = " | ".join(connector.tail[-5:])
        _manager().fail_session(
            uid, f"training subprocess exited (rc={rc}) without reporting a "
                 f"result{('; last output: ' + tail[:500]) if tail else ''}")


def _check_session(uid: str, task_name: str) -> Optional[EaseVoiceResponse]:
    info = _manager().get_session_info()
    current = info.get(uid, {})
    if (current.get("task_name") != task_name
            or current.get("status") != Status.RUNNING):
        response = EaseVoiceResponse(ResponseStatus.FAILED,
                                     "Task name does not match.")
        _manager().end_session_with_response(uid, response)
        return response
    return None


def stop_task_with_subprocess(uuid: str, task_name: str) -> EaseVoiceResponse:
    check = _check_session(uuid, task_name)
    if check:
        return check
    pid = _manager().get_session_subprocess(uuid)
    if pid:
        _manager().remove_session_subprocess(uuid)
        kill_proc_tree(pid)
        response = EaseVoiceResponse(ResponseStatus.SUCCESS,
                                     "Task stopped by user.")
    else:
        response = EaseVoiceResponse(ResponseStatus.FAILED, "No task to stop.")
    _manager().end_session_with_response(uuid, response)
    return response


def _parent_pids() -> Dict[int, int]:
    """pid -> parent pid of every process in /proc."""
    out = {}
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/stat") as f:
                stat = f.read()
        except OSError:
            continue
        # the command name, in parentheses, may itself hold spaces or ")"
        out[int(name)] = int(stat[stat.rindex(")") + 2:].split()[1])
    return out


def descendants(pid: int) -> List[int]:
    """Every descendant of ``pid``, children first (psutil's
    ``children(recursive=True)``)."""
    children: Dict[int, List[int]] = {}
    for child, parent in _parent_pids().items():
        children.setdefault(parent, []).append(child)
    out, todo = [], list(children.get(pid, []))
    while todo:
        p = todo.pop(0)
        out.append(p)
        todo.extend(children.get(p, []))
    return out


def kill_proc_tree(pid: int, including_parent: bool = True) -> None:
    if not os.path.exists(f"/proc/{pid}"):
        return
    for child in descendants(pid):
        try:
            os.kill(child, signal.SIGTERM)
        except OSError:
            pass
    if including_parent:
        try:
            os.kill(pid, signal.SIGTERM)
        except OSError:
            pass
