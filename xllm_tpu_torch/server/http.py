"""A small HTTP/1.1 server on the standard library's ``asyncio``.

The JAX package's OpenAI server is written on ``aiohttp.web``; the port's
runs where aiohttp is not installed, so this module gives the part of
``aiohttp.web`` that ``server/api.py`` and ``server/registry.py`` use,
under the same names, and the handlers read as the JAX package's do:

- ``Application`` (``router.add_get`` / ``add_post``, ``on_startup`` /
  ``on_cleanup``, item access), routes with ``{name}`` segments
  (``request.match_info``);
- ``Request`` (``method``, ``path``, ``query``, ``headers``, ``await
  read()`` / ``json()``, ``transport``);
- ``Response``, ``json_response`` and ``StreamResponse`` (``prepare`` /
  ``write`` / ``write_eof``, sent chunked; every ``write`` drains to the
  socket before it returns, so server-sent events leave one by one);
- ``AppRunner`` + ``TCPSite`` (``site.port`` is the bound port when asked
  for port 0) and ``run_app``, which stops on SIGINT / SIGTERM and runs
  ``on_cleanup``.

Connections persist (HTTP/1.1 keep-alive; HTTP/1.0 on request). Request
bodies come with ``Content-Length`` or ``Transfer-Encoding: chunked``; an
``Expect: 100-continue`` is answered once the route is known; a body of
the application's ``client_max_size`` or more (aiohttp's default, 1 MiB,
unless ``Application(client_max_size=...)`` asks for another, as
aiohttp's does) is refused with 413. A body is read into one buffer.
An unknown path answers 404, a known path with another method 405, a
malformed request line 400, and a handler that raises 500 (or, once its
stream has started, a closed connection). When the peer has gone,
``StreamResponse.write`` raises ``ConnectionResetError``, as aiohttp's
does. Every accepted socket has ``TCP_NODELAY`` set.
"""

from __future__ import annotations

import asyncio
import json
import re
import signal
import socket
from email.utils import formatdate
from http import HTTPStatus
from urllib.parse import parse_qsl, unquote, urlsplit

from xllm_tpu_torch.utils import get_logger

logger = get_logger(__name__)

CLIENT_MAX_SIZE = 1024 ** 2  # aiohttp's default client_max_size
_MAX_LINE = 8190  # request line and each header line (aiohttp's limits)
_MAX_HEADERS = 128
_MAX_DISCARD = 64 * CLIENT_MAX_SIZE  # an oversized body read before its 413
_SERVER = "xllm-tpu-torch"


class HTTPError(Exception):
    """A request the transport refuses before any handler runs."""

    def __init__(self, status: int, reason: str = "", close: bool = True):
        super().__init__(reason)
        self.status = status
        self.reason = reason or HTTPStatus(status).phrase
        self.close = close


class Headers(dict):
    """Case-insensitive header map (the last value of a repeated name)."""

    def __init__(self, items=()):
        super().__init__()
        for k, v in items:
            self[k] = v

    def __setitem__(self, key, value):
        super().__setitem__(key.lower(), value)

    def __getitem__(self, key):
        return super().__getitem__(key.lower())

    def __contains__(self, key):
        return super().__contains__(key.lower())

    def get(self, key, default=None):
        return super().get(key.lower(), default)


# ---------------------------------------------------------------------------
# application and routing
# ---------------------------------------------------------------------------
class _Router:
    def __init__(self):
        self._routes: list[tuple[re.Pattern, str, object]] = []

    def add_route(self, method: str, path: str, handler) -> None:
        pattern = re.sub(r"\\\{(\w+)\\\}", r"(?P<\1>[^/]+)", re.escape(path))
        self._routes.append((re.compile(pattern + "$"), method.upper(), handler))

    def add_get(self, path: str, handler) -> None:
        self.add_route("GET", path, handler)

    def add_post(self, path: str, handler) -> None:
        self.add_route("POST", path, handler)

    def resolve(self, method: str, path: str):
        """-> (handler, match_info); HTTPError 404 / 405."""
        allowed = []
        for pattern, m, handler in self._routes:
            match = pattern.match(path)
            if match is None:
                continue
            if m == method:
                return handler, {k: unquote(v) for k, v in match.groupdict().items()}
            allowed.append(m)
        if allowed:
            raise HTTPError(405, close=False)
        raise HTTPError(404, close=False)


class Application(dict):
    """Routes, startup / cleanup hooks and shared state (item access);
    bodies of ``client_max_size`` bytes or more are refused with 413."""

    def __init__(self, client_max_size: int = CLIENT_MAX_SIZE):
        super().__init__()
        self.client_max_size = client_max_size
        self.router = _Router()
        self.on_startup: list = []
        self.on_cleanup: list = []


# ---------------------------------------------------------------------------
# requests and responses
# ---------------------------------------------------------------------------
class Request:
    def __init__(self, app, method, target, version, headers, transport):
        self.app = app
        self.method = method
        self.version = version
        parts = urlsplit(target)
        self.path = unquote(parts.path)
        self.query = dict(reversed(parse_qsl(parts.query, keep_blank_values=True)))
        self.headers = headers
        self.transport = transport
        self.match_info: dict = {}
        self._body = b""

    async def read(self) -> bytes:
        return self._body

    async def json(self):
        return json.loads(self._body.decode("utf-8"))


def _content_type(content_type: str | None, charset: str | None) -> str | None:
    if content_type and charset:
        return f"{content_type}; charset={charset}"
    return content_type


class Response:
    """A response whose body is known when the handler returns."""

    def __init__(self, *, body: bytes | str | None = None, status: int = 200,
                 text: str | None = None, content_type: str | None = None,
                 charset: str | None = None, headers: dict | None = None):
        if text is not None:
            body = text
            content_type = content_type or "text/plain"
            charset = charset or "utf-8"
        if isinstance(body, str):
            body = body.encode(charset or "utf-8")
        self.body = body or b""
        self.status = status
        self.headers = Headers((headers or {}).items())
        ctype = _content_type(content_type, charset)
        if ctype:
            self.headers["Content-Type"] = ctype
        elif "Content-Type" not in self.headers:
            self.headers["Content-Type"] = "application/octet-stream"


def json_response(data, *, status: int = 200) -> Response:
    return Response(body=json.dumps(data), status=status,
                    content_type="application/json", charset="utf-8")


class StreamResponse:
    """A response sent as it is written: the status line and headers at
    ``prepare``, then each ``write`` as one chunk that reaches the socket
    before ``write`` returns."""

    def __init__(self, *, status: int = 200, headers: dict | None = None):
        self.status = status
        self.headers = Headers((headers or {}).items())
        self.prepared = False
        self.finished = False
        self._conn: _Connection | None = None
        self._chunked = True

    async def prepare(self, request: Request) -> None:
        if self.prepared:
            return
        conn = request._conn
        self._conn = conn
        self._chunked = request.version >= (1, 1)
        if self._chunked:
            self.headers["Transfer-Encoding"] = "chunked"
        else:
            conn.keep_alive = False  # an HTTP/1.0 stream ends at close
        self.headers.setdefault("content-type", "application/octet-stream")
        conn.started = True
        self.prepared = True
        await conn.send_head(self.status, self.headers)

    async def write(self, data: bytes) -> None:
        if not self.prepared:
            raise RuntimeError("write() before prepare()")
        if data:
            await self._conn.send(
                b"%x\r\n%s\r\n" % (len(data), data) if self._chunked else data)

    async def write_eof(self) -> None:
        if self.finished:
            return
        self.finished = True
        if self._chunked:
            await self._conn.send(b"0\r\n\r\n")


# ---------------------------------------------------------------------------
# one connection
# ---------------------------------------------------------------------------
class _Connection:
    def __init__(self, app: Application, reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter):
        self.app = app
        self.reader = reader
        self.writer = writer
        self.keep_alive = True
        self.started = False  # a response's head was sent
        sock = writer.get_extra_info("socket")
        if sock is not None and sock.family in (socket.AF_INET, socket.AF_INET6):
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)

    def gone(self) -> bool:
        """The peer closed its side, or the transport is closing."""
        return self.writer.is_closing() or self.reader.at_eof()

    async def send(self, data: bytes) -> None:
        if self.gone():
            raise ConnectionResetError("Cannot write to closing transport")
        self.writer.write(data)
        await self.writer.drain()

    async def send_head(self, status: int, headers: Headers) -> None:
        try:
            phrase = HTTPStatus(status).phrase
        except ValueError:
            phrase = "Unknown"
        headers.setdefault("date", formatdate(usegmt=True))
        headers.setdefault("server", _SERVER)
        headers["Connection"] = "keep-alive" if self.keep_alive else "close"
        lines = [f"HTTP/1.1 {status} {phrase}"]
        lines += [f"{_title(k)}: {v}" for k, v in headers.items()]
        await self.send(("\r\n".join(lines) + "\r\n\r\n").encode("latin-1"))

    async def send_response(self, resp: Response) -> None:
        resp.headers["Content-Length"] = str(len(resp.body))
        self.started = True
        await self.send_head(resp.status, resp.headers)
        if resp.body:
            await self.send(resp.body)

    async def send_error(self, status: int, reason: str = "") -> None:
        text = f"{status}: {reason or HTTPStatus(status).phrase}"
        await self.send_response(Response(text=text, status=status))

    # -- reading ----------------------------------------------------------
    async def _line(self) -> bytes:
        try:
            line = await self.reader.readuntil(b"\n")
        except asyncio.IncompleteReadError as e:
            if e.partial:
                raise HTTPError(400, "incomplete request line") from None
            raise EOFError from None
        except asyncio.LimitOverrunError:
            raise HTTPError(400, "line too long") from None
        if len(line) > _MAX_LINE + 2:
            raise HTTPError(400, "line too long")
        return line.rstrip(b"\r\n")

    async def read_head(self) -> Request:
        line = await self._line()
        while not line:  # tolerate blank lines between requests
            line = await self._line()
        try:
            method, target, proto = line.decode("latin-1").split(" ")
            if not proto.startswith("HTTP/1.") or not re.fullmatch(r"[A-Z]+", method):
                raise ValueError(proto)
            version = (1, int(proto[7:]))
        except ValueError:
            raise HTTPError(400, "malformed request line") from None
        items = []
        while True:
            line = await self._line()
            if not line:
                break
            if len(items) >= _MAX_HEADERS or b":" not in line:
                raise HTTPError(400, "malformed header")
            k, v = line.decode("latin-1").split(":", 1)
            items.append((k.strip(), v.strip()))
        headers = Headers(items)
        conn_opt = headers.get("Connection", "").lower()
        self.keep_alive = (conn_opt != "close" if version >= (1, 1)
                           else conn_opt == "keep-alive")
        req = Request(self.app, method, target, version, headers, self.writer.transport)
        req._conn = self
        return req

    async def read_body(self, req: Request) -> bytes:
        te = req.headers.get("Transfer-Encoding", "").lower()
        if te:
            if te != "chunked":
                raise HTTPError(400, f"unsupported transfer encoding {te!r}")
            return await self._read_chunked(req)
        length = req.headers.get("Content-Length")
        if length is None:
            return b""
        if not length.isdigit():
            raise HTTPError(400, "bad Content-Length")
        n = int(length)
        if n >= self.app.client_max_size:
            if req.headers.get("Expect", "").lower() != "100-continue":
                await self._discard(n)  # the peer is sending it: read it first
            raise HTTPError(413)
        await self._continue(req)
        try:
            return await self.reader.readexactly(n)
        except asyncio.IncompleteReadError:
            raise EOFError from None

    async def _discard(self, n: int) -> None:
        """Read and drop up to ``n`` body bytes (at most ``_MAX_DISCARD``),
        so a refusal reaches a peer that is still sending."""
        n = min(n, _MAX_DISCARD)
        while n > 0:
            chunk = await self.reader.read(min(n, 1 << 16))
            if not chunk:
                return
            n -= len(chunk)

    async def _continue(self, req: Request) -> None:
        if req.headers.get("Expect", "").lower() == "100-continue":
            self.writer.write(b"HTTP/1.1 100 Continue\r\n\r\n")
            await self.writer.drain()

    async def _read_chunked(self, req: Request) -> bytes:
        await self._continue(req)
        body = bytearray()
        while True:
            line = await self._line()
            try:
                size = int(line.split(b";", 1)[0].strip(), 16)
            except ValueError:
                raise HTTPError(400, "bad chunk size") from None
            if size == 0:
                while await self._line():  # trailers
                    pass
                return bytes(body)
            if len(body) + size >= self.app.client_max_size:
                await self._discard(size + 2)
                raise HTTPError(413)
            try:
                body += await self.reader.readexactly(size)
                crlf = await self.reader.readexactly(2)
            except asyncio.IncompleteReadError:
                raise EOFError from None
            if crlf != b"\r\n":
                raise HTTPError(400, "bad chunk")

    # -- the loop -----------------------------------------------------------
    async def serve(self) -> None:
        try:
            while True:
                self.started = False
                req = None
                try:
                    req = await self.read_head()
                    handler, req.match_info = self.app.router.resolve(req.method, req.path)
                    req._body = await self.read_body(req)
                except HTTPError as e:
                    if not e.close:
                        # 404 / 405: the body is read and dropped, so the
                        # connection stays usable
                        try:
                            await self.read_body(req)
                        except HTTPError:
                            self.keep_alive = False
                    else:
                        self.keep_alive = False
                    await self.send_error(e.status, e.reason)
                    if not self.keep_alive:
                        return
                    continue
                if not await self._dispatch(handler, req):
                    return
                if not self.keep_alive:
                    return
        except (EOFError, ConnectionError):
            return
        finally:
            self.writer.close()

    async def _dispatch(self, handler, req: Request) -> bool:
        """Run the handler and send its response -> whether the connection
        can take another request."""
        try:
            resp = await handler(req)
        except ConnectionError:
            return False  # the peer went away mid-response
        except Exception:
            logger.exception("handler for %s %s raised", req.method, req.path)
            if self.started:
                return False  # mid-stream: only closing tells the peer
            self.keep_alive = False
            await self.send_error(500, "Internal Server Error")
            return False
        if isinstance(resp, StreamResponse):
            if not resp.prepared:
                await resp.prepare(req)
            await resp.write_eof()
        else:
            await self.send_response(resp)
        return True


def _title(name: str) -> str:
    return "-".join(p.capitalize() for p in name.split("-"))


# ---------------------------------------------------------------------------
# running an application
# ---------------------------------------------------------------------------
class AppRunner:
    def __init__(self, app: Application):
        self.app = app
        self.sites: list[TCPSite] = []
        self._connections: set[asyncio.Task] = set()

    async def setup(self) -> None:
        for hook in self.app.on_startup:
            await hook(self.app)

    async def _on_connection(self, reader, writer) -> None:
        task = asyncio.current_task()
        self._connections.add(task)
        try:
            await _Connection(self.app, reader, writer).serve()
        finally:
            self._connections.discard(task)

    async def cleanup(self) -> None:
        for site in self.sites:
            await site.stop()
        for task in list(self._connections):
            task.cancel()
        if self._connections:
            await asyncio.wait(list(self._connections), timeout=5)
        for hook in self.app.on_cleanup:
            await hook(self.app)


class TCPSite:
    def __init__(self, runner: AppRunner, host: str = "0.0.0.0", port: int = 8080):
        self.runner = runner
        self.host = host
        self.port = port
        self._server: asyncio.base_events.Server | None = None

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self.runner._on_connection, self.host, self.port, limit=_MAX_LINE + 2)
        self.port = self._server.sockets[0].getsockname()[1]
        self.runner.sites.append(self)

    @property
    def name(self) -> str:
        return f"http://{self.host}:{self.port}"

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None


def run_app(app: Application, host: str = "0.0.0.0", port: int = 8080) -> None:
    """Serve ``app`` until SIGINT or SIGTERM, then stop listening, close
    the connections and run ``on_cleanup``."""

    async def main():
        runner = AppRunner(app)
        await runner.setup()
        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            loop.add_signal_handler(sig, stop.set)
        try:
            site = TCPSite(runner, host, port)
            await site.start()
            print(f"======== Running on {site.name} ========\n(Press CTRL+C to quit)",
                  flush=True)
            await stop.wait()
        finally:
            for sig in (signal.SIGINT, signal.SIGTERM):
                loop.remove_signal_handler(sig)
            await runner.cleanup()

    asyncio.run(main())
