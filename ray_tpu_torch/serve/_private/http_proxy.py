"""HTTP ingress proxy — asyncio, streaming, bounded timeouts.

Reference: serve/_private/http_proxy.py:320,553 (HTTPProxyActor: a uvicorn
ASGI server per node routing requests to replicas through the same Router
as handles, with response streaming). Here: a single asyncio event loop
serves every connection — requests resolve through the ASYNC handle path
(`await response`, seal-callback driven), so hundreds of requests can be
in flight on one thread; no thread-per-request, no hardwired timeout.

Contract:
  POST/GET /<app_name>            JSON body in, {"result": ...} out
  POST/GET /<app_name>?stream=1   chunked response, one JSON line per item
                                  yielded by the (generator) ingress
  header  X-Serve-Timeout-S: <s>  per-request deadline (default from
                                  start_proxy(request_timeout_s=...))
"""

from __future__ import annotations

import asyncio
import json
import threading
from typing import Optional
from urllib.parse import parse_qs, urlparse

_MAX_HEADER_BYTES = 64 * 1024
_MAX_BODY_BYTES = 256 * 1024 * 1024


class _BadRequest(Exception):
    pass


async def _read_request(reader: asyncio.StreamReader):
    """Minimal HTTP/1.1 request parser: returns (method, path, headers,
    body) or None on EOF between requests (keep-alive close)."""
    try:
        request_line = await reader.readline()
    except ConnectionError:
        return None
    except (ValueError, asyncio.LimitOverrunError):
        # StreamReader wraps over-limit lines in ValueError.
        raise _BadRequest("request line too long") from None
    if not request_line:
        return None
    parts = request_line.decode("latin-1").rstrip("\r\n").split(" ")
    if len(parts) != 3:
        raise _BadRequest("malformed request line")
    method, target, _version = parts
    headers: dict[str, str] = {}
    total = 0
    while True:
        try:
            line = await reader.readline()
        except (ValueError, asyncio.LimitOverrunError):
            raise _BadRequest("header line too long") from None
        total += len(line)
        if total > _MAX_HEADER_BYTES:
            raise _BadRequest("headers too large")
        if line in (b"\r\n", b"\n", b""):
            break
        key, _, value = line.decode("latin-1").partition(":")
        headers[key.strip().lower()] = value.strip()
    try:
        length = int(headers.get("content-length", "0") or "0")
    except ValueError:
        raise _BadRequest("bad Content-Length") from None
    if length < 0 or length > _MAX_BODY_BYTES:
        raise _BadRequest("body too large")
    body = await reader.readexactly(length) if length else b""
    return method, target, headers, body


def _json_response(code: int, payload: dict) -> bytes:
    body = json.dumps(payload).encode()
    status = {200: "OK", 400: "Bad Request", 404: "Not Found",
              500: "Internal Server Error", 504: "Gateway Timeout"}
    return (
        f"HTTP/1.1 {code} {status.get(code, 'OK')}\r\n"
        f"Content-Type: application/json\r\n"
        f"Content-Length: {len(body)}\r\n"
        f"Connection: keep-alive\r\n\r\n"
    ).encode() + body


class HTTPProxyActor:
    """Asyncio ingress server. Runs its event loop on one daemon thread;
    every request is a task on that loop (also deployable as a per-node
    actor: the class has no head-only dependencies)."""

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 8000,
        request_timeout_s: float = 60.0,
    ):
        self._host = host
        self._port = port
        self._timeout_s = request_timeout_s
        # Bounded: submissions briefly block on replica selection; an
        # unbounded default executor would let a flood of requests spawn a
        # thread each (weak spot vs the reference's uvicorn worker model).
        from concurrent.futures import ThreadPoolExecutor

        self._submit_pool = ThreadPoolExecutor(
            max_workers=32, thread_name_prefix="serve-submit"
        )
        self._handles: dict[str, object] = {}
        self._ready = threading.Event()
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._server: Optional[asyncio.AbstractServer] = None
        self._boot_error: Optional[BaseException] = None
        self._thread = threading.Thread(
            target=self._run_loop, daemon=True, name="serve-http"
        )
        self._thread.start()
        if not self._ready.wait(10.0) or self._boot_error is not None:
            raise OSError(
                f"HTTP proxy failed to bind {host}:{port}: "
                f"{self._boot_error or 'timeout'}"
            )

    # -- event loop ---------------------------------------------------------

    def _run_loop(self) -> None:
        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        self._loop = loop

        async def boot():
            try:
                self._server = await asyncio.start_server(
                    self._serve_conn, self._host, self._port
                )
                self._port = self._server.sockets[0].getsockname()[1]
            except BaseException as exc:  # surfaced by __init__
                self._boot_error = exc
                raise
            finally:
                self._ready.set()

        try:
            loop.run_until_complete(boot())
        except BaseException:
            loop.close()
            return
        try:
            loop.run_forever()
        finally:
            loop.close()

    async def _serve_conn(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        try:
            while True:
                try:
                    req = await _read_request(reader)
                except _BadRequest as exc:
                    writer.write(_json_response(400, {"error": str(exc)}))
                    await writer.drain()
                    return
                if req is None:
                    return
                method, target, headers, body = req
                await self._handle_request(writer, target, headers, body)
                await writer.drain()
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            try:
                writer.close()
            except Exception:
                pass

    async def _handle_request(
        self, writer, target: str, headers: dict, body: bytes
    ) -> None:
        parsed = urlparse(target)
        app_name = parsed.path.strip("/") or "default"
        query = {k: v[-1] for k, v in parse_qs(parsed.query).items()}
        stream = query.get("stream") in ("1", "true")
        try:
            timeout_s = float(
                headers.get("x-serve-timeout-s", self._timeout_s)
            )
        except ValueError:
            timeout_s = self._timeout_s
        try:
            payload = json.loads(body) if body else None
        except json.JSONDecodeError:
            payload = body.decode("utf-8", "replace")
        try:
            handle = self._get_handle(app_name)
        except Exception as exc:
            writer.write(_json_response(404, {"error": str(exc)}))
            return
        if stream:
            await self._stream_response(writer, handle, payload, timeout_s)
            return
        try:
            # Submission runs in the executor: replica selection can briefly
            # block when every replica is at max_concurrent_queries, and the
            # event loop must keep serving other requests meanwhile. Both
            # the submission AND the reply wait are bounded by the request
            # deadline; the WAIT itself is fully async (seal-callback
            # driven).
            loop = asyncio.get_event_loop()
            deadline = loop.time() + timeout_s
            response = await asyncio.wait_for(
                loop.run_in_executor(
                    self._submit_pool, lambda: handle.remote(payload)
                ),
                timeout=timeout_s,
            )
            result = await asyncio.wait_for(
                response, timeout=max(0.0, deadline - loop.time())
            )
            writer.write(_json_response(200, {"result": result}))
        except asyncio.TimeoutError:
            writer.write(
                _json_response(504, {"error": f"timed out after {timeout_s}s"})
            )
        except Exception as exc:
            writer.write(_json_response(500, {"error": str(exc)}))

    async def _stream_response(
        self, writer, handle, payload, timeout_s: float
    ) -> None:
        """Chunked transfer: one JSON line per generator item, flushed as
        produced (the reference proxy's ASGI streaming path)."""
        writer.write(
            b"HTTP/1.1 200 OK\r\n"
            b"Content-Type: application/x-ndjson\r\n"
            b"Transfer-Encoding: chunked\r\n"
            b"Connection: keep-alive\r\n\r\n"
        )

        def chunk(data: bytes) -> bytes:
            return f"{len(data):X}\r\n".encode() + data + b"\r\n"

        loop = asyncio.get_event_loop()
        deadline = loop.time() + timeout_s
        gen = None
        try:
            # Submission off-loop (replica selection can briefly block);
            # every item wait is deadline-bounded so a stalled generator
            # still honors X-Serve-Timeout-S.
            stream_handle = handle.options(stream=True)
            gen = await asyncio.wait_for(
                loop.run_in_executor(
                    self._submit_pool, lambda: stream_handle.remote(payload)
                ),
                timeout=max(0.0, deadline - loop.time()),
            )
            aiter = gen.__aiter__()
            while True:
                try:
                    item = await asyncio.wait_for(
                        aiter.__anext__(),
                        timeout=max(0.0, deadline - loop.time()),
                    )
                except StopAsyncIteration:
                    break
                line = json.dumps({"result": item}).encode() + b"\n"
                writer.write(chunk(line))
                await asyncio.wait_for(
                    writer.drain(),
                    timeout=max(0.0, deadline - loop.time()),
                )
        except asyncio.TimeoutError:
            self._cancel_stream(gen)
            writer.write(
                chunk(json.dumps({"error": f"timed out after {timeout_s}s"})
                      .encode() + b"\n")
            )
        except Exception as exc:
            # Includes client disconnects surfacing from drain(): either way
            # the consumer is gone, so stop the replica-side generator.
            self._cancel_stream(gen)
            writer.write(
                chunk(json.dumps({"error": str(exc)}).encode() + b"\n")
            )
        writer.write(b"0\r\n\r\n")

    @staticmethod
    def _cancel_stream(gen) -> None:
        """Abandoned stream: cancel the replica generator so it stops
        producing into the object store and frees its concurrency slot."""
        if gen is not None:
            try:
                gen.cancel()
            except Exception:
                pass

    # -- plumbing -----------------------------------------------------------

    def _get_handle(self, app_name: str):
        handle = self._handles.get(app_name)
        if handle is None:
            from ray_tpu_torch.serve.api import get_app_handle

            handle = get_app_handle(app_name)
            self._handles[app_name] = handle
        return handle

    def address(self) -> tuple[str, int]:
        return self._host, self._port

    def shutdown(self) -> None:
        loop = self._loop
        if loop is None:
            return

        def _stop():
            if self._server is not None:
                self._server.close()
            loop.stop()

        try:
            loop.call_soon_threadsafe(_stop)
            self._thread.join(timeout=5.0)
        except Exception:
            pass
        self._submit_pool.shutdown(wait=False, cancel_futures=True)


_proxy: Optional[HTTPProxyActor] = None


def start_proxy(
    host: str = "127.0.0.1", port: int = 0, request_timeout_s: float = 60.0
) -> tuple[str, int]:
    """Start (or return) the in-process HTTP proxy; returns (host, port)."""
    global _proxy
    if _proxy is None:
        _proxy = HTTPProxyActor(host, port, request_timeout_s)
    return _proxy.address()


def stop_proxy() -> None:
    global _proxy
    if _proxy is not None:
        _proxy.shutdown()
        _proxy = None
