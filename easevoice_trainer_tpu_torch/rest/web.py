"""A small web layer on the standard library's ``ThreadingHTTPServer``,
with the parts of aiohttp's ``web`` that the REST app uses and the same
answers on the wire:

* routes by method and path pattern (``{name}`` matches one segment,
  ``{name:regex}`` the regex); an unknown path answers 404 "404: Not Found",
  a known path with another method 405 "405: Method Not Allowed" with
  ``Allow``; a GET route also answers HEAD;
* ``Request``: ``query`` (first value of each key), ``match_info``, the body
  read on demand (``read``, ``json``) with ``client_max_size`` (413 with
  aiohttp's text beyond it);
* a handler that raises answers aiohttp's 500 ("500 Internal Server
  Error\\n\\nServer got itself in trouble", HTML where the client accepts
  it) and closes the connection;
* ``json_response`` (``json.dumps`` defaults, ``application/json;
  charset=utf-8``), ``Response``, ``FileResponse`` and a static directory;
* startup and cleanup hooks around serving.

The port's server depends on nothing beyond the standard library: no
aiohttp, which the port does not require of the machines it runs on.
"""
from __future__ import annotations

import html
import json
import mimetypes
import os
import re
import threading
from email.utils import formatdate
from http import HTTPStatus
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional, Tuple
from urllib.parse import parse_qsl, unquote, urlsplit

from ..utils.logger import logger


class HTTPException(Exception):
    """Raised by a handler (or the body reader) to answer ``status`` with a
    plain-text body, as aiohttp's ``web.HTTPException`` does."""

    def __init__(self, status: int, text: Optional[str] = None,
                 headers: Optional[Dict[str, str]] = None):
        super().__init__(text)
        self.status = status
        self.text = text if text is not None else \
            f"{status}: {HTTPStatus(status).phrase}"
        self.headers = headers or {}


class Response:
    def __init__(self, status: int = 200, body: bytes = b"",
                 content_type: Optional[str] = None,
                 headers: Optional[Dict[str, str]] = None, path: str = ""):
        self.status = status
        self.body = body
        self.headers = dict(headers or {})
        if content_type and "Content-Type" not in self.headers:
            self.headers["Content-Type"] = content_type
        self.path = path            # a file to send in place of ``body``

    @classmethod
    def text(cls, status: int, text: str, content_type: str = "text/plain",
             headers: Optional[Dict[str, str]] = None) -> "Response":
        return cls(status, text.encode("utf-8"),
                   f"{content_type}; charset=utf-8", headers)


def json_response(data: Any, status: int = 200) -> Response:
    return Response(status, json.dumps(data).encode("utf-8"),
                    "application/json; charset=utf-8")


def file_response(path: str) -> Response:
    ctype, encoding = mimetypes.guess_type(path)
    st = os.stat(path)
    headers = {"Content-Type": ctype or "application/octet-stream",
               "Last-Modified": formatdate(st.st_mtime, usegmt=True),
               "Accept-Ranges": "bytes"}
    if encoding:
        headers["Content-Encoding"] = encoding
    return Response(200, headers=headers, path=path)


class Request:
    def __init__(self, handler: BaseHTTPRequestHandler, path: str,
                 query_string: str, client_max_size: int):
        self._handler = handler
        self.method = handler.command
        self.path = path
        self.query_string = query_string
        self.query = {}
        for k, v in parse_qsl(query_string, keep_blank_values=True):
            self.query.setdefault(k, v)
        self.headers = handler.headers
        self.match_info: Dict[str, str] = {}
        self._max = client_max_size
        self._body: Optional[bytes] = None

    @property
    def body_pending(self) -> bool:
        return self._body is None and (
            int(self.headers.get("Content-Length") or 0) > 0
            or "chunked" in self.headers.get("Transfer-Encoding", ""))

    def read(self) -> bytes:
        if self._body is None:
            rfile = self._handler.rfile
            if "chunked" in self.headers.get("Transfer-Encoding", ""):
                parts, size = [], 0
                while True:
                    n = int(rfile.readline().split(b";")[0].strip(), 16)
                    if n == 0:
                        while rfile.readline() not in (b"\r\n", b"\n", b""):
                            pass
                        break
                    size += n
                    if self._max and size > self._max:
                        raise HTTPException(413, self._too_large(size))
                    parts.append(rfile.read(n))
                    rfile.readline()
                self._body = b"".join(parts)
            else:
                n = int(self.headers.get("Content-Length") or 0)
                if self._max and n > self._max:
                    raise HTTPException(413, self._too_large(n))
                self._body = rfile.read(n) if n else b""
        return self._body

    def _too_large(self, size: int) -> str:
        return (f"Maximum request body size {self._max} exceeded, "
                f"actual body size {size}")

    def text(self) -> str:
        charset = "utf-8"
        m = re.search(r"charset=([\w-]+)",
                      self.headers.get("Content-Type", ""))
        if m:
            charset = m.group(1)
        return self.read().decode(charset)

    def json(self) -> Any:
        return json.loads(self.text())


Handler = Callable[[Request], Response]


def _compile(pattern: str) -> "re.Pattern":
    out, pos = "", 0
    for m in re.finditer(r"\{(\w+)(?::([^{}]*))?\}", pattern):
        out += re.escape(pattern[pos:m.start()])
        out += f"(?P<{m.group(1)}>{m.group(2) or '[^{}/]+'})"
        pos = m.end()
    return re.compile(out + re.escape(pattern[pos:]) + r"\Z")


class Application:
    def __init__(self, client_max_size: int = 1024 ** 2):
        self.client_max_size = client_max_size
        self.routes: List[Tuple[str, "re.Pattern", Handler]] = []
        self.statics: List[Tuple[str, str]] = []
        self.on_startup: List[Callable[["Application"], None]] = []
        self.on_cleanup: List[Callable[["Application"], None]] = []

    def route(self, method: str, pattern: str) -> Callable[[Handler],
                                                           Handler]:
        """Decorator: ``method`` is an HTTP method or ``"*"`` for any."""
        def add(fn: Handler) -> Handler:
            self.routes.append((method.upper(), _compile(pattern), fn))
            return fn
        return add

    def get(self, pattern: str):
        return self.route("GET", pattern)

    def post(self, pattern: str):
        return self.route("POST", pattern)

    def put(self, pattern: str):
        return self.route("PUT", pattern)

    def delete(self, pattern: str):
        return self.route("DELETE", pattern)

    def add_static(self, prefix: str, directory: str) -> None:
        self.statics.append((prefix.rstrip("/") + "/",
                             os.path.abspath(directory)))

    # ---- dispatch ---------------------------------------------------------

    def resolve(self, request: Request) -> Response:
        allowed = set()
        for method, regex, fn in self.routes:
            m = regex.match(request.path)
            if m is None:
                continue
            if method in ("*", request.method) or (
                    method == "GET" and request.method == "HEAD"):
                request.match_info = m.groupdict()
                return fn(request)
            allowed.add(method)
            if method == "GET":
                allowed.add("HEAD")
        for prefix, directory in self.statics:
            if request.path.startswith(prefix) and request.method in (
                    "GET", "HEAD"):
                path = os.path.abspath(os.path.join(
                    directory, request.path[len(prefix):]))
                if path.startswith(directory + os.sep) and \
                        os.path.isfile(path):
                    return file_response(path)
        if allowed:
            raise HTTPException(405, headers={
                "Allow": ",".join(sorted(allowed))})
        raise HTTPException(404)

    def handle(self, request: Request) -> Tuple[Response, bool]:
        """-> (response, close the connection)."""
        try:
            return self.resolve(request), False
        except HTTPException as e:
            return Response.text(e.status, e.text, headers=e.headers), \
                e.status == 413
        except Exception:
            logger.exception("Error handling request %s %s", request.method,
                             request.path)
            status = HTTPStatus.INTERNAL_SERVER_ERROR
            title = f"{status.value} {status.phrase}"
            if "text/html" in request.headers.get("Accept", ""):
                page = (f"<html><head><title>{html.escape(title)}</title>"
                        f"</head><body>\n<h1>{title}</h1>\n"
                        f"{status.description}\n</body></html>\n")
                return Response.text(500, page, "text/html"), True
            return Response.text(500, f"{title}\n\n{status.description}"), \
                True

    # ---- serving ----------------------------------------------------------

    def make_server(self, host: str, port: int) -> "Server":
        return Server(self, host, port)


class Server(ThreadingHTTPServer):
    """One thread a connection.  ``start`` runs the app's startup hooks
    (before ``serve_forever``), ``close_app`` closes the socket and runs
    its cleanup hooks."""

    daemon_threads = True

    def __init__(self, app: Application, host: str, port: int):
        self.app = app
        super().__init__((host, port), _RequestHandler)

    def start(self) -> None:
        for hook in self.app.on_startup:
            hook(self.app)

    def close_app(self) -> None:
        self.server_close()
        for hook in self.app.on_cleanup:
            hook(self.app)

    def serve_in_thread(self) -> threading.Thread:
        self.start()
        thread = threading.Thread(target=self.serve_forever, daemon=True)
        thread.start()
        return thread

    def shutdown_app(self) -> None:
        """Stops ``serve_in_thread``'s loop, then ``close_app``."""
        self.shutdown()
        self.close_app()


class _RequestHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_version = "easevoice"

    def _dispatch(self) -> None:
        url = urlsplit(self.path)
        request = Request(self, unquote(url.path), url.query,
                          self.server.app.client_max_size)
        response, close = self.server.app.handle(request)
        if request.body_pending:
            close = True        # the unread body is still on the socket
        self._send(response, close)

    def _send(self, response: Response, close: bool) -> None:
        body = response.body
        size = os.path.getsize(response.path) if response.path else len(body)
        self.send_response(response.status)
        for k, v in response.headers.items():
            self.send_header(k, v)
        if response.status != 204:
            self.send_header("Content-Length", str(size))
        if close:
            self.send_header("Connection", "close")
            self.close_connection = True
        self.end_headers()
        if self.command == "HEAD" or response.status in (204, 304):
            return
        if response.path:
            with open(response.path, "rb") as f:
                while True:
                    chunk = f.read(1 << 20)
                    if not chunk:
                        break
                    self.wfile.write(chunk)
        else:
            self.wfile.write(body)

    do_GET = do_POST = do_PUT = do_DELETE = do_PATCH = do_HEAD = \
        do_OPTIONS = _dispatch

    def log_message(self, format: str, *args) -> None:
        logger.debug("%s - %s", self.address_string(), format % args)
