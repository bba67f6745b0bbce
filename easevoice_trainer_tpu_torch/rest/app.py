"""REST API server: the full /apis/v1 surface of the JAX package's
``rest/app.py``, route for route, on the standard library (``rest/web.py``):

  /namespaces[...]          NamespaceAPI
  /directories /files /delete-dirs-files     FileAPI
  /session /session/current                  SessionAPI
  /voiceclone/clone /voiceclone/models       VoiceCloneAPI
  /train/{gpt,sovits}/{start,stop}           TrainAPI
  /normalize/{start,stop}                    NormalizeAPI
  /audio/{uvr5,slicer,denoise,asr}/{start,stop} + /audio/refinement[...]
  /easevoice/{start,stop}                    EaseVoiceAPI (one-click)
  /profiler/{start,stop}                     torch.profiler trace
  /tensorboard/{path}                        reverse proxy to :6006
  /  /assets/*                               SPA static (./dist)

Responses keep the JAX envelope: start endpoints return EaseVoiceResponse
JSON; conflicts are HTTP 409 with {"detail": ...}; a handler that raises
(a malformed body, a missing key) answers aiohttp's 500.

The server runs on one device (``build_app(device=...)``, the card unless
the caller asks for the CPU): the subprocess tasks get it in their params
(``service/session.py``) and the voice clone builds its TTS on it.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import datetime
import json
import os
import urllib.error
import urllib.request
import uuid as uuid_mod
from enum import Enum
from typing import Any, Optional

from ..normalization import random_choice
from ..service import session as session_mod
from ..service.audio import (
    AudioService, AudioUVR5Params, AudioSlicerParams, AudioDenoiseParams,
    AudioASRParams)
from ..service.file import FileService
from ..service.namespace import NamespaceService
from ..service.normalize import NormalizeParams
from ..service.session import (
    SessionConflictError, backtask_with_session_guard, session_manager,
    start_task_with_subprocess, stop_task_with_subprocess)
from ..service.tensorboard import TENSORBOARD_PORT, TensorBoardService
from ..service.voice import VoiceCloneService, list_train_gpts, \
    list_train_sovits
from ..train.gpt import GPTTrainParams, get_gpt_train_dir
from ..train.sovits import SovitsTrainParams, get_sovits_train_dir
from ..utils import paths
from ..utils.device import resolve_device
from ..utils.logger import logger
from ..utils.response import EaseVoiceResponse, ResponseStatus
from . import web
from .types import TaskCMD, TaskType

API_PREFIX = "/apis/v1"


def _json(data: Any, status: int = 200) -> web.Response:
    def default(o):
        if isinstance(o, EaseVoiceResponse):
            return o.to_dict()
        if isinstance(o, Enum):
            return o.value
        if dataclasses.is_dataclass(o):
            return dataclasses.asdict(o)
        return str(o)

    return web.json_response(
        json.loads(json.dumps(data, default=default)), status=status)


def _resp(r: EaseVoiceResponse, status: int = 200) -> web.Response:
    return _json(r.to_dict(), status)


def _error(status: int, detail: Any) -> web.Response:
    return _json({"detail": detail}, status)


def _conflict() -> web.Response:
    return _error(409, {"error": "There is an another task running."})


def _generate_name() -> str:
    return datetime.datetime.now().strftime("%Y%m%d-%H%M%S")


def _start_subprocess_task(task_type: str, cmd_module: str, request_obj,
                           extra_data: Optional[dict] = None
                           ) -> web.Response:
    if session_manager.exist_running_session():
        return _conflict()
    uid = str(uuid_mod.uuid4())
    # the server's device, whatever the body said: the session records the
    # params the child is given
    params = session_mod.task_params(request_obj)
    try:
        backtask_with_session_guard(
            uid, task_type, params, start_task_with_subprocess,
            uid=uid, cmd_module=cmd_module, request=params)
    except SessionConflictError:
        return _conflict()
    return _resp(EaseVoiceResponse(
        ResponseStatus.SUCCESS, f"{task_type} started", uuid=uid,
        data=extra_data))


def _stop_subprocess_task(task_type: str, request: web.Request
                          ) -> web.Response:
    uid = request.query.get("uid", "")
    try:
        return _resp(stop_task_with_subprocess(uid, task_type))
    except Exception as e:
        logger.exception("failed to stop %s", task_type)
        return _error(500, {"error": f"failed to stop {task_type}: {e}"})


def _dataclass_from(params: dict, cls):
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in params.items() if k in names})


class _Profiler:
    """torch.profiler behind /profiler/{start,stop}: CPU activity, plus
    CUDA activity on a CUDA server; the stop writes a Chrome trace under
    ``tb_log_dir()/profile``.  A second start, or a stop with none
    running, raises (500 upstream), as ``jax.profiler`` does.

    The profiler is started and stopped on one thread of its own (Kineto
    aborts when another thread stops it).  Its CPU-side op records are
    that thread's alone; the device's kernel records (CUPTI) are the whole
    process's, so a clone running on its task thread shows there."""

    def __init__(self, device: str):
        self.device = device
        self.prof = None
        self.trace_dir = ""
        self.thread = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="profiler")

    def start(self) -> str:
        return self.thread.submit(self._start).result()

    def stop(self) -> None:
        self.thread.submit(self._stop).result()

    def _start(self) -> str:
        import torch

        if self.prof is not None:
            raise RuntimeError("Only one profile may be run at a time.")
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.startswith("cuda"):
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self.trace_dir = os.path.join(paths.tb_log_dir(), "profile")
        os.makedirs(self.trace_dir, exist_ok=True)
        prof = torch.profiler.profile(activities=activities)
        prof.start()
        self.prof = prof
        return self.trace_dir

    def _stop(self) -> None:
        if self.prof is None:
            raise RuntimeError("No profile started")
        prof, self.prof = self.prof, None
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            self.trace_dir, datetime.datetime.now().strftime(
                "%Y_%m_%d_%H_%M_%S_%f") + ".pt.trace.json"))


def build_app(frontend_dir: Optional[str] = None,
              require_frontend: bool = False,
              device="cuda") -> web.Application:
    device = str(resolve_device(device, "build_app"))
    session_manager.device = device
    app = web.Application(client_max_size=1024 ** 3)
    file_service = FileService()
    namespace_service = NamespaceService()
    tensorboard_service = TensorBoardService()
    profiler = _Profiler(device)

    # ---- namespaces --------------------------------------------------------

    @app.get(f"{API_PREFIX}/namespaces")
    def list_namespaces(request):
        return _json({"namespaces": namespace_service.get_namespaces()})

    @app.post(f"{API_PREFIX}/namespaces")
    def new_namespace(request):
        body = request.json()
        name = body.get("name", "")
        if not name or "/" in name or "\0" in name or name in (".", ".."):
            return _error(400, "invalid namespace name")
        try:
            return _json(namespace_service.create_namespace(name))
        except FileExistsError:
            return _error(409, "Namespace already exists")
        except ValueError as e:
            return _error(400, str(e))

    @app.put(f"{API_PREFIX}/namespaces/{{name}}")
    def change_namespace(request):
        body = request.json()
        try:
            return _json(namespace_service.update_namespace(
                request.match_info["name"], body["name"]))
        except FileExistsError:
            return _error(409, "Namespace already exists")
        except ValueError as e:
            return _error(404, str(e))

    @app.delete(f"{API_PREFIX}/namespaces/{{name}}")
    def remove_namespace(request):
        try:
            namespace_service.delete_namespace(request.match_info["name"])
            return web.Response(status=204)
        except ValueError as e:
            return _error(404, str(e))

    @app.get(f"{API_PREFIX}/namespaces-root")
    def get_ns_root(request):
        return _json(namespace_service.get_namespaces_root_metadata())

    @app.post(f"{API_PREFIX}/namespaces-root")
    def set_ns_root(request):
        body = request.json()
        try:
            namespace_service.set_namespaces_root(body["namespaces-root"])
            return _json({"message": "ok"})
        except (KeyError, ValueError) as e:
            return _error(400, str(e))

    # ---- files ---------------------------------------------------------------

    @app.post(f"{API_PREFIX}/directories")
    def create_directory(request):
        body = request.json()
        try:
            file_service.create_directory(body["directoryPath"])
            return _json({"message": "Directory created successfully"})
        except ValueError as e:
            return _error(409 if "Conflict" in str(e) else 400, str(e))

    @app.get(f"{API_PREFIX}/directories")
    def list_directory(request):
        try:
            return _json(file_service.list_directory(
                request.query.get("directoryPath", "")))
        except ValueError as e:
            return _error(404 if "Not Found" in str(e) else 400, str(e))

    @app.post(f"{API_PREFIX}/files")
    def upload_file(request):
        body = request.json()
        try:
            file_service.upload_file(body["directoryPath"], body["fileName"],
                                     body["fileContent"])
            return _json({"message": "File uploaded successfully"})
        except (KeyError, ValueError) as e:
            return _error(400, str(e))

    @app.get(f"{API_PREFIX}/files")
    def download_file(request):
        path = request.query.get("filePath", "")
        if not os.path.exists(path):
            return _error(404, "File not found")
        if os.path.isdir(path):
            return _error(400, "Path is a directory, not a file")
        return web.file_response(path)

    @app.post(f"{API_PREFIX}/delete-dirs-files")
    def delete_dirs_files(request):
        body = request.json()
        return _json(file_service.delete_dirs_files(body.get("paths", [])))

    # ---- session ---------------------------------------------------------------

    @app.get(f"{API_PREFIX}/session")
    def get_sessions(request):
        return _json(session_manager.get_session_info())

    @app.get(f"{API_PREFIX}/session/current")
    def get_current_session(request):
        return _json(session_manager.get_current_session_info())

    # ---- voice clone --------------------------------------------------------------

    @app.get(f"{API_PREFIX}/voiceclone/models")
    def voiceclone_models(request):
        project_dir = request.query.get("project_dir", "")
        try:
            return _json({
                "gpts": ["default"] + sorted(list_train_gpts(project_dir)),
                "sovits": ["default"] + sorted(list_train_sovits(project_dir)),
            })
        except Exception as e:
            return _error(500, {"error": f"failed to get available models: {e}"})

    @app.post(f"{API_PREFIX}/voiceclone/clone")
    def voiceclone_clone(request):
        body = request.json()
        if session_manager.exist_running_session():
            return _conflict()
        uid = str(uuid_mod.uuid4())

        def do_clone(uid: str, task: dict):
            # a fresh service, and so a fresh TTS, for every request, on
            # the server's device
            service = VoiceCloneService(session_manager, device=device)
            try:
                service.clone(uid, task)
            except Exception as e:
                logger.exception("voice clone failed")
                session_manager.end_session_with_response(
                    uid, EaseVoiceResponse(ResponseStatus.FAILED, str(e)))

        try:
            backtask_with_session_guard(uid, TaskType.voice_clone, body,
                                        do_clone, uid=uid, task=body)
        except SessionConflictError:
            return _conflict()
        return _resp(EaseVoiceResponse(ResponseStatus.SUCCESS,
                                       "Voice clone started", uuid=uid))

    # ---- training ---------------------------------------------------------------

    @app.post(f"{API_PREFIX}/train/gpt/start")
    def train_gpt(request):
        params = _dataclass_from(request.json(), GPTTrainParams)
        if not params.output_model_name:
            params.output_model_name = "gpt_" + _generate_name()
        model_path = get_gpt_train_dir(params.project_dir,
                                       params.output_model_name)
        return _start_subprocess_task(TaskType.train_gpt, TaskCMD.train_gpt,
                                      params, {"model_path": model_path})

    @app.delete(f"{API_PREFIX}/train/gpt/stop")
    def train_gpt_stop(request):
        return _stop_subprocess_task(TaskType.train_gpt, request)

    @app.post(f"{API_PREFIX}/train/sovits/start")
    def train_sovits(request):
        params = _dataclass_from(request.json(), SovitsTrainParams)
        if not params.output_model_name:
            params.output_model_name = "sovits_" + _generate_name()
        model_path = get_sovits_train_dir(params.project_dir,
                                          params.output_model_name)
        return _start_subprocess_task(TaskType.train_sovits,
                                      TaskCMD.train_sovits, params,
                                      {"model_path": model_path})

    @app.delete(f"{API_PREFIX}/train/sovits/stop")
    def train_sovits_stop(request):
        return _stop_subprocess_task(TaskType.train_sovits, request)

    # ---- normalize -----------------------------------------------------------------

    @app.post(f"{API_PREFIX}/normalize/start")
    def normalize_start(request):
        params = _dataclass_from(request.json(), NormalizeParams)
        params.predefined_output_path = random_choice()
        base = params.processing_path or params.output_dir
        return _start_subprocess_task(
            TaskType.normalize, TaskCMD.normalize, params,
            {"normalize_path": os.path.join(base,
                                            params.predefined_output_path)})

    @app.delete(f"{API_PREFIX}/normalize/stop")
    def normalize_stop(request):
        return _stop_subprocess_task(TaskType.normalize, request)

    # ---- audio ----------------------------------------------------------------------

    for task_name, cmd_name, cls in (
            (TaskType.audio_uvr5, TaskCMD.audio_uvr5, AudioUVR5Params),
            (TaskType.audio_slicer, TaskCMD.audio_slicer, AudioSlicerParams),
            (TaskType.audio_denoise, TaskCMD.audio_denoise,
             AudioDenoiseParams),
            (TaskType.audio_asr, TaskCMD.audio_asr, AudioASRParams)):
        short = task_name.replace("audio_", "")

        def make_start(task_name=task_name, cmd_name=cmd_name, cls=cls):
            def start(request):
                params = _dataclass_from(request.json(), cls)
                return _start_subprocess_task(task_name, cmd_name, params)
            return start

        def make_stop(task_name=task_name):
            def stop(request):
                return _stop_subprocess_task(task_name, request)
            return stop

        app.post(f"{API_PREFIX}/audio/{short}/start")(make_start())
        app.delete(f"{API_PREFIX}/audio/{short}/stop")(make_stop())

    @app.get(f"{API_PREFIX}/audio/refinement")
    def refinement_list(request):
        service = AudioService(request.query.get("input_dir", ""),
                               request.query.get("output_dir", ""), device)
        return _resp(service.refinement_load_source())

    @app.post(f"{API_PREFIX}/audio/refinement")
    def refinement_submit(request):
        body = request.json()
        service = AudioService(body.get("source_dir", ""),
                               body.get("output_dir", ""), device)
        return _resp(service.refinement_submit_text(
            body["source_file_path"], body["language"],
            body["text_content"]))

    @app.delete(f"{API_PREFIX}/audio/refinement")
    def refinement_delete(request):
        body = request.json()
        service = AudioService(body.get("source_dir", ""),
                               body.get("output_dir", ""), device)
        return _resp(service.refinement_delete_text(body["source_file_path"]))

    @app.post(f"{API_PREFIX}/audio/refinement/reload")
    def refinement_reload(request):
        body = request.json()
        service = AudioService(body.get("source_dir", ""),
                               body.get("output_dir", ""), device)
        return _resp(service.refinement_reload_source())

    # ---- one-click -----------------------------------------------------------------

    @app.post(f"{API_PREFIX}/easevoice/start")
    def easevoice_start(request):
        body = request.json()
        body["gpt_output_name"] = "gpt_" + _generate_name()
        body["sovits_output_name"] = "sovits_" + _generate_name()
        return _start_subprocess_task(
            TaskType.ease_voice, TaskCMD.ease_voice, body,
            {"sovits_output": body["sovits_output_name"],
             "gpt_output": body["gpt_output_name"]})

    @app.delete(f"{API_PREFIX}/easevoice/stop")
    def easevoice_stop(request):
        return _stop_subprocess_task(TaskType.ease_voice, request)

    # ---- profiler ----------------------------------------------------------------------

    @app.post(f"{API_PREFIX}/profiler/start")
    def profiler_start(request):
        try:
            trace_dir = profiler.start()
            return _json({"message": "profiler started",
                          "trace_dir": trace_dir})
        except Exception as e:
            return _error(500, str(e))

    @app.post(f"{API_PREFIX}/profiler/stop")
    def profiler_stop(request):
        try:
            profiler.stop()
            return _json({"message": "profiler stopped"})
        except Exception as e:
            return _error(500, str(e))

    # ---- tensorboard proxy ------------------------------------------------------------

    @app.route("*", f"{API_PREFIX}/tensorboard/{{path:.*}}")
    def tensorboard_proxy(request):
        target = (f"http://localhost:{TENSORBOARD_PORT}/"
                  f"{request.match_info['path']}")
        if request.query_string:
            target += "?" + request.query_string
        upstream_req = urllib.request.Request(
            target, data=request.read() or None, method=request.method,
            headers={k: v for k, v in request.headers.items()
                     if k.lower() not in ("host", "content-length")})
        try:
            try:
                upstream = urllib.request.urlopen(upstream_req, timeout=60)
            except urllib.error.HTTPError as e:
                upstream = e            # a status of its own, passed on
            with upstream:
                body = upstream.read()
                ctype = upstream.headers.get_content_type()
            return web.Response(upstream.status, body, ctype)
        except Exception as e:
            return _error(502, f"tensorboard unavailable: {e}")

    # ---- frontend static (a ./dist build, else the built-in panel) --------------------
    fdir = frontend_dir or os.path.join(os.getcwd(), "dist")
    if not os.path.isdir(fdir):
        builtin = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "panel")
        if os.path.isdir(builtin) and not require_frontend:
            logger.info("no ./dist build; serving the built-in panel")
            fdir = builtin
    if os.path.isdir(fdir):
        @app.get("/")
        def index(request):
            return web.file_response(os.path.join(fdir, "index.html"))

        assets = os.path.join(fdir, "assets")
        if os.path.isdir(assets):
            app.add_static("/assets", assets)
    elif require_frontend:
        raise FileNotFoundError(
            f"Frontend build directory '{fdir}' not found. "
            "Please build the frontend first.")
    else:
        logger.warning("frontend dist/ not found; SPA routes disabled")

    # ---- tensorboard lifecycle ---------------------------------------------------------
    app.on_startup.append(lambda app: tensorboard_service.start())
    app.on_cleanup.append(lambda app: tensorboard_service.stop())
    return app
