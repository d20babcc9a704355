"""HTTP command center (port of ``sentinel_tpu/transport/command_center.py``).

Reference: the CommandCenter SPI + CommandHandler/@CommandMapping
discovery (sentinel-transport-common/.../command/CommandHandler.java,
annotation/CommandMapping.java, CommandHandlerProvider) served over a
minimal HTTP endpoint (sentinel-transport-simple-http/.../
SimpleHttpCommandCenter.java:48, http/HttpEventTask.java). Handlers are
registered with :func:`command_mapping` and dispatched by URL path;
both GET query params and POST form bodies populate the request.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, NamedTuple, Optional
from urllib.parse import parse_qsl, urlparse

from sentinel_tpu_torch.utils.record_log import record_log


class CommandRequest(NamedTuple):
    path: str
    params: Dict[str, str]
    body: str


class CommandResponse(NamedTuple):
    success: bool
    result: str
    content_type: str = "text/plain; charset=utf-8"

    @classmethod
    def of_success(cls, result: str, json_body: bool = False) -> "CommandResponse":
        return cls(True, result, "application/json" if json_body else "text/plain; charset=utf-8")

    @classmethod
    def of_json(cls, obj) -> "CommandResponse":
        return cls(True, json.dumps(obj), "application/json")

    @classmethod
    def of_failure(cls, msg: str) -> "CommandResponse":
        return cls(False, msg)


_handlers: Dict[str, Callable[[CommandRequest], CommandResponse]] = {}
_descriptions: Dict[str, str] = {}


def command_mapping(name: str, desc: str = ""):
    """@CommandMapping equivalent — registers a handler under /name."""

    def deco(fn):
        _handlers[name] = fn
        _descriptions[name] = desc
        return fn

    return deco


def get_handler(name: str):
    return _handlers.get(name)


def all_commands() -> Dict[str, str]:
    return dict(_descriptions)


class _HttpHandler(BaseHTTPRequestHandler):
    server_version = "sentinel-tpu-command-center"

    def log_message(self, fmt, *args):  # route to record log, not stderr
        record_log.debug("[CommandCenter] " + fmt, *args)

    def _dispatch(self, body: str) -> None:
        parsed = urlparse(self.path)
        name = parsed.path.strip("/")
        params = dict(parse_qsl(parsed.query))
        if body:
            params.update(dict(parse_qsl(body)))
        handler = _handlers.get(name)
        if handler is None:
            self._respond(400, f"Unknown command `{name}`; known: {sorted(_handlers)}")
            return
        try:
            resp = handler(CommandRequest(name, params, body))
        except Exception as e:  # handler crash must not kill the server
            record_log.error("[CommandCenter] handler %s failed", name, exc_info=True)
            self._respond(500, f"command error: {e}")
            return
        self._respond(200 if resp.success else 400, resp.result, resp.content_type)

    def _respond(self, code: int, body: str, content_type: str = "text/plain; charset=utf-8"):
        data = body.encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self) -> None:
        self._dispatch("")

    def do_POST(self) -> None:
        try:
            length = int(self.headers.get("Content-Length") or 0)
        except ValueError:
            length = -1
        if length < 0:
            self._respond(400, "bad Content-Length")
            return
        if length > 10 * 1024 * 1024:
            self._respond(413, "body too large")
            return
        raw = self.rfile.read(length) if length else b""
        try:
            body = raw.decode("utf-8")
        except UnicodeDecodeError:
            self._respond(400, "body is not valid UTF-8")
            return
        self._dispatch(body)


class CommandCenter:
    """The simple-http command center (start on the transport port)."""

    def __init__(self, port: int = 0) -> None:
        self._requested_port = port
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        # Ensure built-in handlers are registered.
        from sentinel_tpu_torch.transport import handlers as _  # noqa: F401

    @property
    def port(self) -> int:
        if self._server is None:
            return self._requested_port
        return self._server.server_address[1]

    def start(self) -> "CommandCenter":
        if self._server is not None:
            return self
        self._server = ThreadingHTTPServer(("0.0.0.0", self._requested_port), _HttpHandler)
        self._server.daemon_threads = True
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="sentinel-command-center", daemon=True
        )
        self._thread.start()
        record_log.info("[CommandCenter] listening on %d", self.port)
        return self

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
