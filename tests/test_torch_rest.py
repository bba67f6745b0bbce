"""The port's REST server (``easevoice_trainer_tpu_torch.rest.app`` on the
standard library) against the JAX package's aiohttp app, on the CPU.

Each route group sends one request sequence (that of tests/test_rest.py,
plus the error cases) to the JAX app (``web.AppRunner`` + ``TCPSite`` on
127.0.0.1:0, in a background event loop) and to the port's server
(``build_app(device="cpu")`` on 127.0.0.1:0), each in a fresh workspace,
through one ``urllib`` client.  The status codes, content types and bodies
must agree once uuids, timestamps, ``cpu_percentage`` and each server's
workspace path are masked, with these differences on purpose:

* the session of a subprocess task records the params its child is given,
  which carry the server's device (``"device": "cpu"`` here, whatever the
  body said);
* the profiler's and the TensorBoard proxy's error texts come from
  ``torch.profiler`` / ``urllib`` in place of ``jax.profiler`` / aiohttp's
  client (the status codes agree);
* the built-in panel's title names CUDA where the JAX one names the TPU.

Then the port alone: every task route hands its child the server's device;
a stop kills a stub child and its grandchild (the ``/proc`` walk) and the
session reads "Completed"; ``main.py --dry-run``; and a greedy clone
through each server from the same tiny ``.pth`` / ``.ckpt`` files, whose
wavs agree within tests/test_torch_tts.py's 4 int16 LSB.
"""
import asyncio
import base64
import json
import os
import re
import shutil
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.parse
import urllib.request

import numpy as np
import pytest
import torch
from aiohttp import web as aioweb

from easevoice_trainer_tpu import native as jnative
from easevoice_trainer_tpu.inference import tts as jtts
from easevoice_trainer_tpu.inference.preprocessor import \
    TextPreprocessor as JPre
from easevoice_trainer_tpu.models.cnhubert import CNHubert as JHubert, \
    HubertConfig as JHubertConfig
from easevoice_trainer_tpu.models.gpt import T2SConfig as JT2SConfig, \
    Text2SemanticDecoder as JT2S
from easevoice_trainer_tpu.models.sovits import SovitsConfig as JSovitsConfig, \
    SynthesizerTrn as JSynth
from easevoice_trainer_tpu.rest import app as japp
from easevoice_trainer_tpu.service import session as jsession
from easevoice_trainer_tpu.utils import audio_io
from easevoice_trainer_tpu_torch import native as pnative
from easevoice_trainer_tpu_torch.inference import tts as ptts
from easevoice_trainer_tpu_torch.inference.preprocessor import \
    TextPreprocessor as PPre
from easevoice_trainer_tpu_torch.models.gpt import T2SConfig
from easevoice_trainer_tpu_torch.models.sovits import SovitsConfig
from easevoice_trainer_tpu_torch.rest import app as papp
from easevoice_trainer_tpu_torch.rest.types import TaskCMD
from easevoice_trainer_tpu_torch.service import session as psession

from _torch_port_tiny import HUBERT_KW, SOVITS_KW, T2S_KW, tiny_gpt, \
    tiny_hubert, tiny_sovits

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P = "/apis/v1"
WAV_ATOL = 4    # int16 LSBs, as tests/test_torch_tts.py states


# ---- the two servers ----------------------------------------------------------

class JaxServer:
    def __init__(self):
        jsession.SessionManager.reset()
        jsession.session_manager = jsession.SessionManager()
        japp.session_manager = jsession.session_manager
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever,
                                       daemon=True)
        self.thread.start()
        app = japp.build_app(frontend_dir=os.path.join(os.getcwd(), "nodist"))
        self.runner = aioweb.AppRunner(app)
        self._call(self.runner.setup())
        site = aioweb.TCPSite(self.runner, "127.0.0.1", 0)
        self._call(site.start())
        port = site._server.sockets[0].getsockname()[1]
        self.url = f"http://127.0.0.1:{port}"

    def _call(self, coro):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(60)

    def close(self):
        self._call(self.runner.cleanup())
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(10)
        self.loop.close()


class PortServer:
    def __init__(self):
        psession.SessionManager.reset()
        psession.session_manager = psession.SessionManager()
        papp.session_manager = psession.session_manager
        self.manager = psession.session_manager
        app = papp.build_app(frontend_dir=os.path.join(os.getcwd(), "nodist"),
                             device="cpu")
        self.server = app.make_server("127.0.0.1", 0)
        self.server.serve_in_thread()
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"

    def close(self):
        self.server.shutdown_app()


def call(url, method, path, body=None, query=None, raw=None, headers=None):
    """-> (status, media type, body: parsed JSON, text, or bytes)."""
    if query:
        path += "?" + urllib.parse.urlencode(query)
    data = raw if raw is not None else (
        json.dumps(body).encode() if body is not None else None)
    req = urllib.request.Request(url + path, data=data, method=method,
                                 headers=headers or {})
    try:
        resp = urllib.request.urlopen(req, timeout=60)
    except urllib.error.HTTPError as e:
        resp = e
    with resp:
        payload = resp.read()
        ctype = resp.headers.get("Content-Type", "")
    if ctype.startswith("application/json"):
        payload = json.loads(payload)
    elif ctype.startswith("text/"):
        payload = payload.decode()
    return resp.status, ctype, payload


UUID = re.compile(r"[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{4}-"
                  r"[0-9a-f]{12}")
STAMP = re.compile(r"\d{8}-\d{6}")


def mask(obj, root):
    """uuids, timestamps, cpu_percentage and the workspace path masked."""
    if isinstance(obj, dict):
        out = {}
        for k, v in obj.items():
            if k in ("created_at", "createdAt", "modifiedAt",
                     "cpu_percentage"):
                v = "<masked>"
            out[UUID.sub("<uuid>", k)] = mask(v, root)
        return out
    if isinstance(obj, (list, tuple)):
        return [mask(v, root) for v in obj]
    if isinstance(obj, str):
        return STAMP.sub("<stamp>", UUID.sub("<uuid>", obj.replace(
            root, "<root>")))
    return obj


def _workspace(tmp_path, name):
    """A fresh cwd and namespace root a server, and a base path with the
    repo's configs (the subprocess tasks read configs/s2.json there)."""
    root = str(tmp_path / name)
    os.makedirs(os.path.join(root, "base"))
    shutil.copytree(os.path.join(REPO, "configs"),
                    os.path.join(root, "base", "configs"))
    return root


def run_both(tmp_path, monkeypatch, sequence):
    """``sequence(url, root)`` -> list of responses, on each
    server in its own workspace; -> (jax transcript, port transcript), each
    masked."""
    out = []
    for name, cls in (("jax", JaxServer), ("port", PortServer)):
        root = _workspace(tmp_path, name)
        monkeypatch.chdir(root)
        monkeypatch.setenv("EASEVOICE_TRAINER_NAMESPACES_ROOT",
                           os.path.join(root, "namespaces"))
        monkeypatch.setenv("EASEVOICE_BASE_PATH", os.path.join(root, "base"))
        server = cls()
        try:
            out.append(mask(sequence(server.url, root),
                            root))
        finally:
            server.close()
    return out


def _strip_device(transcript):
    """The port's session records carry the server's device: it must be
    "cpu", and is removed for the comparison."""
    def walk(obj):
        if isinstance(obj, dict):
            req = obj.get("request")
            if isinstance(req, dict) and "device" in req:
                assert req.pop("device") == "cpu", req
            for v in obj.values():
                walk(v)
        elif isinstance(obj, list):
            for v in obj:
                walk(v)
    walk(transcript)
    return transcript


def _wait_done(url, uid, timeout=120):
    deadline = time.time() + timeout
    while time.time() < deadline:
        info = call(url, "GET", f"{P}/session")[2].get(uid, {})
        if info.get("status") in ("Completed", "Failed"):
            return info
        time.sleep(0.2)
    raise AssertionError(f"session {uid} still running")


# ---- the route groups ------------------------------------------------------------

def seq_namespaces(url, root):
    r = [call(url, "GET", f"{P}/namespaces"),
         call(url, "POST", f"{P}/namespaces", {"name": "proj1"})]
    home = r[-1][2]["homePath"]
    r.append(sorted(os.path.relpath(os.path.join(d, s), home)
                    for d, subs, _ in os.walk(home) for s in subs))
    r.append(os.path.exists(os.path.join(home, ".metadata.json")))
    r += [call(url, "POST", f"{P}/namespaces", {"name": "proj1"}),
          call(url, "POST", f"{P}/namespaces", {"name": "../evil"}),
          call(url, "POST", f"{P}/namespaces", {"name": ""}),
          call(url, "POST", f"{P}/namespaces", {}),
          call(url, "POST", f"{P}/namespaces", {"name": "proj3"}),
          call(url, "PUT", f"{P}/namespaces/proj1", {"name": "proj2"}),
          call(url, "PUT", f"{P}/namespaces/proj2", {"name": "proj3"}),
          call(url, "PUT", f"{P}/namespaces/ghost", {"name": "x"}),
          call(url, "PUT", f"{P}/namespaces/proj2", {}),
          call(url, "GET", f"{P}/namespaces"),
          call(url, "DELETE", f"{P}/namespaces/proj2"),
          call(url, "DELETE", f"{P}/namespaces/ghost"),
          call(url, "GET", f"{P}/namespaces-root")]
    r += [call(url, "POST", f"{P}/namespaces-root",
               {"namespaces-root": os.path.join(root, "other_root")}),
          call(url, "POST", f"{P}/namespaces-root", {"root": "x"}),
          call(url, "GET", f"{P}/namespaces-root"),
          call(url, "GET", f"{P}/namespaces")]
    return r


def seq_files(url, root):
    d = os.path.join(root, "data", "sub")
    content = base64.b64encode(b"hello audio").decode()
    f = os.path.join(d, "a.txt")
    return [
        call(url, "POST", f"{P}/directories", {"directoryPath": d}),
        call(url, "POST", f"{P}/directories", {"directoryPath": d}),
        call(url, "POST", f"{P}/directories", {}),
        call(url, "POST", f"{P}/files", {"directoryPath": d,
                                          "fileName": "a.txt",
                                          "fileContent": content}),
        call(url, "POST", f"{P}/files", {"directoryPath": d + "x",
                                          "fileName": "a.txt",
                                          "fileContent": content}),
        call(url, "POST", f"{P}/files", {"directoryPath": d}),
        call(url, "POST", f"{P}/files", {"directoryPath": d,
                                          "fileName": "b.txt",
                                          "fileContent": "***"}),
        call(url, "GET", f"{P}/directories", query={"directoryPath": d}),
        call(url, "GET", f"{P}/directories", query={"directoryPath": f}),
        call(url, "GET", f"{P}/directories",
             query={"directoryPath": d + "x"}),
        call(url, "GET", f"{P}/directories"),
        call(url, "GET", f"{P}/files", query={"filePath": f}),
        call(url, "GET", f"{P}/files", query={"filePath": f + "x"}),
        call(url, "GET", f"{P}/files", query={"filePath": d}),
        call(url, "POST", f"{P}/delete-dirs-files",
             {"paths": [d, "/no/such/path"]}),
        call(url, "POST", f"{P}/delete-dirs-files", {}),
    ]


def seq_session(url, root):
    return [call(url, "GET", f"{P}/session/current"),
            call(url, "GET", f"{P}/session")]


def seq_refinement(url, root):
    out = os.path.join(root, "proj")
    os.makedirs(os.path.join(out, "asrs"))
    with open(os.path.join(out, "asrs", "asr.list"), "w",
              encoding="utf8") as fp:
        fp.write("a.wav|zh|text one\nb.wav|en|text two\n")
    both = {"source_dir": root, "output_dir": out}
    return [
        call(url, "POST", f"{P}/audio/refinement/reload", both),
        call(url, "GET", f"{P}/audio/refinement",
             query={"input_dir": root, "output_dir": out}),
        call(url, "POST", f"{P}/audio/refinement",
             dict(both, source_file_path="a.wav", language="ZH",
                  text_content="fixed text")),
        call(url, "POST", f"{P}/audio/refinement",
             dict(both, source_file_path="a.wav")),
        call(url, "DELETE", f"{P}/audio/refinement",
             dict(both, source_file_path="a.wav")),
        call(url, "DELETE", f"{P}/audio/refinement", both),
        call(url, "GET", f"{P}/audio/refinement",
             query={"input_dir": root, "output_dir": out}),
    ]


def seq_models(url, root):
    r = [call(url, "GET", f"{P}/voiceclone/models",
              query={"project_dir": root})]
    for sub, name in (("sovits_train/m1", "m1_e1_s2.pth"),
                      ("gpt_train/g1", "g1-e1.ckpt"),
                      ("gpt_train/g0", "g0-e3.ckpt")):
        os.makedirs(os.path.join(root, "models", sub))
        open(os.path.join(root, "models", sub, name), "wb").close()
    r.append(call(url, "GET", f"{P}/voiceclone/models",
                  query={"project_dir": root}))
    r.append(call(url, "GET", f"{P}/voiceclone/models"))
    return r


def seq_train(url, root):
    """A sovits start whose child fails fast (no data dir), a second start
    while it runs (409), a stop with a foreign uid, and the failure."""
    body = {"train_input_dir": os.path.join(root, "missing"),
            "project_dir": root, "output_model_name": "m1",
            "total_epochs": 1, "device": "cuda"}
    first = call(url, "POST", f"{P}/train/sovits/start", body)
    r = [first,
         call(url, "POST", f"{P}/train/sovits/start", body),
         call(url, "POST", f"{P}/train/gpt/start", body),
         call(url, "POST", f"{P}/voiceclone/clone", {"text": "x"})]
    uid = first[2]["uuid"]
    info = _wait_done(url, uid)
    r.append(info)
    r.append(call(url, "GET", f"{P}/session/current"))
    r.append(call(url, "DELETE", f"{P}/train/sovits/stop",
                  query={"uid": uid}))
    r.append(call(url, "DELETE", f"{P}/train/gpt/stop",
                  query={"uid": "nope"}))
    r.append(call(url, "DELETE", f"{P}/audio/uvr5/stop"))
    r.append(call(url, "GET", f"{P}/session"))
    return r


def seq_panel(url, root):
    status, ctype, body = call(url, "GET", "/")
    return [(status, ctype, body.replace("(CUDA)", "(TPU)").replace(
                ">CUDA<", ">TPU<")),
            call(url, "GET", "/assets/app.js"),
            call(url, "HEAD", "/")[:2]]


def seq_errors(url, root):
    r = [call(url, "GET", f"{P}/nothing"),
         call(url, "GET", f"{P}/namespaces/"),
         call(url, "DELETE", f"{P}/session")[:2],
         call(url, "POST", f"{P}/namespaces-root")[:2]]
    for path in ("/namespaces", "/directories", "/files",
                 "/delete-dirs-files", "/audio/refinement/reload",
                 "/train/sovits/start", "/normalize/start",
                 "/audio/asr/start", "/easevoice/start", "/voiceclone/clone"):
        r.append(call(url, "POST", P + path, raw=b"{not json"))
        r.append(call(url, "POST", P + path, raw=b""))
        r.append(call(url, "POST", P + path, raw=b"[1, 2]"))
    r.append(call(url, "POST", f"{P}/namespaces", raw=b"{not json",
                  headers={"Accept": "text/html"}))
    return r


def seq_profiler(url, root):
    r = [call(url, "POST", f"{P}/profiler/start"),
         call(url, "POST", f"{P}/profiler/start"),
         call(url, "POST", f"{P}/profiler/stop"),
         call(url, "POST", f"{P}/profiler/stop")]
    # the error texts are the profilers' own: status codes compared
    for i in (1, 3):
        r[i] = (r[i][0], r[i][1], sorted(r[i][2]))
    return r


def seq_tensorboard(url, root):
    r = []
    for method in ("GET", "POST"):
        status, ctype, body = call(url, method, f"{P}/tensorboard/data/x",
                                   query={"a": "1"})
        prefix = "tensorboard unavailable: "
        assert body["detail"].startswith(prefix), body
        r.append((status, ctype, prefix))
    return r


GROUPS = {"namespaces": seq_namespaces, "files": seq_files,
          "session": seq_session, "refinement": seq_refinement,
          "voiceclone_models": seq_models, "train": seq_train,
          "panel": seq_panel, "errors": seq_errors,
          "profiler": seq_profiler, "tensorboard": seq_tensorboard}


@pytest.mark.parametrize("group", sorted(GROUPS))
def test_rest_matches_jax(group, tmp_path, monkeypatch):
    want, got = run_both(tmp_path, monkeypatch, GROUPS[group])
    assert _strip_device(got) == want


# ---- the port alone ------------------------------------------------------------------

_STUB_CHILD = r"""
import json, os, subprocess, sys, time
params = json.load(open(sys.argv[-1]))
with open(os.environ["STUB_RECORD"], "a") as f:
    f.write(json.dumps({"argv": sys.argv, "params": params,
                        "pid": os.getpid()}) + "\n")
if os.environ.get("STUB_HANG"):
    grand = subprocess.Popen([sys.executable, "-c",
                              "import time; time.sleep(120)"])
    with open(os.environ["STUB_RECORD"], "a") as f:
        f.write(json.dumps({"grandchild": grand.pid}) + "\n")
    print('loss-of-easevoice {"step": 1, "loss": 2.5}', flush=True)
    time.sleep(120)
print('response-of-easevoice {"status": "success", "message": "stub", '
      '"data": null, "uuid": null}', flush=True)
"""


@pytest.fixture
def port_server(tmp_path, monkeypatch):
    """The port's server on the CPU whose subprocess tasks run a stub that
    records its argv and params (``-m <module>`` replaced, the rest kept)."""
    root = _workspace(tmp_path, "port")
    monkeypatch.chdir(root)
    monkeypatch.setenv("EASEVOICE_TRAINER_NAMESPACES_ROOT",
                       os.path.join(root, "namespaces"))
    monkeypatch.setenv("EASEVOICE_BASE_PATH", os.path.join(root, "base"))
    record = os.path.join(root, "record.jsonl")
    monkeypatch.setenv("STUB_RECORD", record)
    popen = subprocess.Popen

    def stub_popen(argv, **kw):
        assert argv[:2] == [sys.executable, "-m"], argv
        return popen([sys.executable, "-c", _STUB_CHILD] + argv[2:], **kw)

    monkeypatch.setattr(psession.subprocess, "Popen", stub_popen)
    server = PortServer()
    try:
        yield server, root, record
    finally:
        server.close()


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_every_task_gets_the_server_device(port_server):
    server, root, record = port_server
    tasks = {"/audio/uvr5/start": TaskCMD.audio_uvr5,
             "/audio/slicer/start": TaskCMD.audio_slicer,
             "/audio/denoise/start": TaskCMD.audio_denoise,
             "/audio/asr/start": TaskCMD.audio_asr,
             "/normalize/start": TaskCMD.normalize,
             "/train/sovits/start": TaskCMD.train_sovits,
             "/train/gpt/start": TaskCMD.train_gpt,
             "/easevoice/start": TaskCMD.ease_voice}
    body = {"source_dir": root, "output_dir": root, "processing_path": root,
            "train_input_dir": root, "project_dir": root,
            "device": "cuda:3"}
    for i, (path, module) in enumerate(tasks.items()):
        status, _, resp = call(server.url, "POST", P + path, body)
        assert status == 200 and resp["status"] == "success", resp
        info = _wait_done(server.url, resp["uuid"])
        assert info["status"] == "Completed" and info["message"] == "stub"
        rec = _records(record)[i]
        # argv: "-c", the module the server asked for, "-c", the params file
        assert rec["argv"][1:3] == [
            f"easevoice_trainer_tpu_torch.cmd.{module}", "-c"], rec["argv"]
        assert rec["params"]["device"] == "cpu", (path, rec["params"])
        assert rec["params"] == info["request"], path


def _alive(pid):
    """False once the process is gone or a zombie."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            stat = f.read()
    except OSError:
        return False
    return stat[stat.rindex(")") + 2] != "Z"


def test_stop_kills_the_task_tree(port_server, monkeypatch):
    server, root, record = port_server
    monkeypatch.setenv("STUB_HANG", "1")
    status, _, resp = call(server.url, "POST", f"{P}/train/sovits/start",
                           {"train_input_dir": root, "project_dir": root})
    uid = resp["uuid"]
    deadline = time.time() + 60
    while not call(server.url, "GET", f"{P}/session/current")[2].get(
            "losses"):
        assert time.time() < deadline, "no loss from the stub"
        time.sleep(0.1)
    recs = _records(record)
    child, grand = recs[0]["pid"], recs[1]["grandchild"]
    assert psession.descendants(child) == [grand]
    assert _alive(child) and _alive(grand)
    status, _, resp = call(server.url, "DELETE", f"{P}/train/sovits/stop",
                           query={"uid": uid})
    assert status == 200 and resp["status"] == "success"
    assert resp["message"] == "Task stopped by user."
    deadline = time.time() + 15
    while _alive(child) or _alive(grand):
        assert time.time() < deadline, "the task tree outlived the stop"
        time.sleep(0.1)
    time.sleep(0.5)    # the reader thread has seen the child's end
    info = call(server.url, "GET", f"{P}/session")[2][uid]
    assert info["status"] == "Completed", info
    assert info["message"] == "Task stopped by user." and \
        info["error"] is None, info
    assert info["losses"] == [{"step": 1, "loss": 2.5, "other": {}}]
    assert not server.manager.exist_running_session()


def test_cpu_meter_is_psutils():
    """/proc/stat deltas: 0-100 with one decimal, like psutil."""
    psession.SessionManager.reset()
    manager = psession.SessionManager()
    manager.device = "cpu"
    sum(i * i for i in range(200000))
    pct = manager.cpu_percent()
    assert 0.0 <= pct <= 100.0 and round(pct, 1) == pct
    metrics = manager._monitor_metrics()["monitor_metrics"]
    assert re.fullmatch(r"\d+(\.\d)?%", metrics["cpu_percentage"])
    assert metrics["accelerator"] == "cpu"
    assert "memory_allocated_percentage" not in metrics


def _main(args, tmp_path):
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    env = dict(os.environ, EASEVOICE_PORT=str(port), PYTHONPATH=REPO,
               EASEVOICE_TRAINER_NAMESPACES_ROOT=str(tmp_path / "ns"),
               EASEVOICE_BASE_PATH=str(tmp_path / "base"))
    return subprocess.run(
        [sys.executable, "-m", "easevoice_trainer_tpu_torch.main"] + args,
        capture_output=True, timeout=120, env=env, cwd=str(tmp_path),
        text=True)


def test_main_dry_run(tmp_path):
    proc = _main(["--dry-run", "--device", "cpu"], tmp_path)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "dry-run: server started OK" in proc.stderr + proc.stdout
    assert not torch.cuda.is_available()
    proc = _main(["--dry-run"], tmp_path)
    assert proc.returncode != 0
    assert "no CUDA card is available" in proc.stderr, proc.stderr[-2000:]


# ---- a greedy clone through each server ------------------------------------------------

TEXT = ("The quick brown fox jumps over the lazy dog. "
        "A journey of a thousand miles begins with one step. "
        "Voice cloning needs a reference clip.")


def _save(state, path, prefix=""):
    torch.save({"weight": {prefix + k: torch.as_tensor(np.asarray(v))
                           for k, v in state.items()},
                "config": {}, "info": "test"}, path)


def test_greedy_clone_matches_jax(tmp_path, monkeypatch):
    """The same tiny .pth / .ckpt files under each workspace's
    models/{sovits_train,gpt_train}, named in the request; each server
    builds its TTS per request (the model widths and the HuBERT are the
    tiny ones, patched into ``_init_models``); top_k 1 draws no
    randomness."""
    monkeypatch.setattr(jnative, "_lib", None)
    monkeypatch.setattr(pnative, "_lib", None)
    (_, _, vstate), (_, _, tstate), (phub, hparams, _) = \
        tiny_sovits(), tiny_gpt(), tiny_hubert()
    vstate = dict(vstate)
    vstate["enc_q.proj.weight"] = np.zeros((4, 4, 1), np.float32)

    def jax_init(self):
        self.vits_cfg = JSovitsConfig(**SOVITS_KW)
        self.vits, self.vits_params = JSynth(self.vits_cfg), None
        self.t2s_cfg = JT2SConfig(**T2S_KW)
        self.t2s, self.t2s_params = JT2S(self.t2s_cfg), None
        self.cnhubert = JHubert(JHubertConfig(**HUBERT_KW))
        self.cnhubert_params = {"params": hparams}
        self.bert, self.preprocessor = None, JPre(None)
        self.cfg.max_sec = 8

    def port_init(self):
        self.vits_cfg = SovitsConfig(**SOVITS_KW)
        self.t2s_cfg = T2SConfig(**T2S_KW)
        self.cnhubert = phub
        self.bert, self.preprocessor = None, PPre(None)
        self.cfg.max_sec = 8

    monkeypatch.setattr(jtts.TTS, "_init_models", jax_init)
    monkeypatch.setattr(ptts.TTS, "_init_models", port_init)

    def clone(url, root):
        for sub, name, state, prefix in (
                ("sovits_train/m", "m_e1_s1.pth", vstate, ""),
                ("gpt_train/g", "g-e1.ckpt", tstate, "model.")):
            os.makedirs(os.path.join(root, "models", sub))
            _save(state, os.path.join(root, "models", sub, name), prefix)
        ref = os.path.join(root, "ref.wav")
        audio_io.write_wav(ref, np.random.default_rng(0).uniform(
            -0.3, 0.3, 32000 * 4).astype(np.float32), 32000)
        status, _, resp = call(url, "POST", f"{P}/voiceclone/clone", dict(
            text=TEXT, text_lang="en", ref_audio_path=ref, prompt_text="",
            text_split_method="by_english_period", batch_size=2, top_k=1,
            seed=7, keep_random=False, sovits_path="m_e1_s1.pth",
            gpt_path="g-e1.ckpt", project_dir=root,
            output_dir=os.path.join(root, "outputs")))
        assert status == 200, resp
        info = _wait_done(url, resp["uuid"], timeout=300)
        assert info["status"] == "Completed", info
        wav, sr = audio_io.read_wav(info["data"]["output_path"])
        return [resp, info, call(url, "GET", f"{P}/voiceclone/models",
                                 query={"project_dir": root}),
                (sr, np.round(wav * 32768).astype(np.int32))]

    want, got = run_both(tmp_path, monkeypatch, clone)
    (_, w), (_, g) = want.pop(), got.pop()
    assert g.shape == w.shape and np.abs(w).max() > 100
    d = np.abs(g - w).max()
    assert d <= WAV_ATOL, d
    assert got == want


def test_trainers_tensorboard_writer(tmp_path, monkeypatch):
    """The trainers' scalars go through torch.utils.tensorboard (or
    tensorboardX) where one imports, and are skipped with the JAX
    package's warning where neither does."""
    from easevoice_trainer_tpu_torch.train import sovits
    from easevoice_trainer_tpu_torch.train.sovits import _tb_writer

    warned = []
    monkeypatch.setattr(sovits.logger, "warning", warned.append)

    writer = _tb_writer(str(tmp_path / "run"))
    if writer is not None:          # a writer imports here
        writer.add_scalar("loss/g/total", 1.5, 5)
        writer.close()
        assert any(n.startswith("events.out.tfevents")
                   for n in os.listdir(tmp_path / "run"))
    for name in ("torch.utils.tensorboard", "tensorboardX"):
        monkeypatch.setitem(sys.modules, name, None)
    assert _tb_writer(str(tmp_path / "off")) is None
    assert warned == ["tensorboard unavailable; scalars not written"]
