"""Connect-or-spawn client for the device server (serve/daemon.py).

``get_client()`` hands out one process-wide client; the query shipper
and the stream feeder share its connection (requests serialize under a
lock — replies arrive only after the daemon verified residency, so
serialization IS the backpressure).  If no daemon answers, one is
spawned detached (``start_new_session``) and the connect retried
briefly; the daemon warms in the background, so the first group call
simply blocks until the (once-per-daemon-lifetime) device warmup
completes — while this run's host race keeps the clock honest.

Every call is failure-isolated: socket errors, timeouts, and
``{ok: false}`` replies raise ``DevdError``; the streamed feeder
surfaces it at ``finish()``, where the compare race records it as the
device leg's error (the host result stands).
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np

from phylonium_tpu.serve.daemon import sock_path
from phylonium_tpu.serve.wire import recv_msg, send_msg


class DevdError(RuntimeError):
    pass


def devd_enabled() -> bool:
    """Should device-bound streaming go through the device server?

    Off by default: the CLI process opens the card itself.
    ``PHYLONIUM_TPU_DEVD=1`` engages the server (CPU-pinned too, for
    tests); the CLI process then never initializes the device backend,
    so one process holds the card.  Whether the server pays on a local
    GPU is a measured decision still open.
    """
    return os.environ.get("PHYLONIUM_TPU_DEVD", "") == "1"


class DevdClient:
    def __init__(self, path: str | None = None, spawn: bool = True):
        self.path = path or sock_path()
        self._lock = threading.Lock()
        # a request is executing on this connection right now — the
        # drain's stall probe reads it: a daemon busy with OUR request
        # (e.g. a race-abandoned finish still compiling) is progress to
        # wait out, not a stall
        self.inflight = False
        self._sock = self._connect(spawn)

    def _try_connect(self, timeout: float):
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        s.settimeout(timeout)
        s.connect(self.path)
        return s

    def _pidfile_alive(self) -> int | None:
        try:
            with open(self.path + ".pid") as f:
                pid = int(f.read().strip())
            os.kill(pid, 0)
            return pid
        except (OSError, ValueError):
            return None

    def _connect(self, spawn: bool):
        try:
            sock = self._try_connect(2.0)
        except OSError:
            if not spawn:
                raise DevdError(f"no device server at {self.path}")
            sock = None
        if sock is not None:
            if spawn and not self._protocol_ok(sock):
                # a daemon from an older build: replace it (its exact
                # pid from the pidfile — never a pattern kill)
                sock.close()
                self._kill_stale()
            else:
                return sock
        deadline = time.time() + float(
            os.environ.get("PHYLONIUM_TPU_DEVD_SPAWN_WAIT", 15.0)
        )
        # spawn ONLY when no live daemon owns the socket: a daemon mid
        # (GIL-heavy) warmup can be slow to accept, and spawning over
        # it would orphan its warm session + content cache — the exact
        # cascade this guard exists for.  A live-but-slow daemon is
        # waited for instead.
        if sock is None and self._pidfile_alive() is None:
            self.spawn_daemon()
        last: Exception | None = None
        while time.time() < deadline:
            try:
                return self._try_connect(2.0)
            except OSError as e:
                last = e
                time.sleep(0.25)
        raise DevdError(f"device server did not come up: {last!r}")

    def _protocol_ok(self, sock) -> bool:
        from phylonium_tpu.serve.daemon import PROTOCOL
        from phylonium_tpu.serve.wire import recv_msg, send_msg

        try:
            sock.settimeout(10.0)
            send_msg(sock, {"op": "ping"})
            reply, _ = recv_msg(sock)
            return reply.get("protocol") == PROTOCOL
        except OSError:
            # busy/unresponsive is not staleness; let requests decide
            return True

    def _kill_stale(self) -> None:
        import signal

        try:
            with open(self.path + ".pid") as f:
                pid = int(f.read().strip())
            os.kill(pid, signal.SIGTERM)
            for _ in range(20):
                try:
                    os.kill(pid, 0)
                except OSError:
                    break
                time.sleep(0.1)
        except (OSError, ValueError):
            pass
        for suffix in ("", ".pid"):
            try:
                os.unlink(self.path + suffix)
            except OSError:
                pass

    def spawn_daemon(self) -> None:
        env = dict(os.environ)
        repo = os.path.dirname(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        )
        env["PYTHONPATH"] = repo + ":" + env.get("PYTHONPATH", "")
        log = self.path + ".log"
        with open(log, "ab") as lf:
            subprocess.Popen(
                [sys.executable, "-m", "phylonium_tpu.serve"],
                stdout=lf,
                stderr=lf,
                stdin=subprocess.DEVNULL,
                start_new_session=True,
                env=env,
            )

    def request(
        self,
        header: dict,
        arrays=(),
        timeout: float = 900.0,
    ) -> tuple[dict, list[np.ndarray]]:
        # timed lock acquire: the connection serializes requests, and a
        # race-abandoned `finish` can hold the lock for as long as its
        # daemon-side compile runs — a caller with a deadline (the
        # cold-run drain's sync prewarm) must fail bounded, not hang
        if not self._lock.acquire(timeout=timeout):
            raise DevdError(
                f"device server busy: connection lock not acquired "
                f"within {timeout:.0f}s"
            )
        self.inflight = True
        try:
            try:
                if self._sock is None:
                    self._sock = self._try_connect(2.0)
                self._sock.settimeout(timeout)
                send_msg(self._sock, header, arrays)
                reply, out = recv_msg(self._sock)
            except OSError as e:
                # the connection is now desynced (a timed-out request's
                # reply may still arrive and would be read as the NEXT
                # request's answer): drop it; the next request reconnects
                if self._sock is not None:
                    try:
                        self._sock.close()
                    except Exception:  # noqa: BLE001
                        pass
                    self._sock = None
                raise DevdError(f"device server i/o failed: {e!r}")
        finally:
            self.inflight = False
            self._lock.release()
        if not reply.get("ok"):
            raise DevdError(
                f"device server: {reply.get('error', 'request failed')}"
            )
        return reply, out

    def ping(self, timeout: float = 5.0) -> dict:
        reply, _ = self.request({"op": "ping"}, timeout=timeout)
        return reply

    def close(self) -> None:
        if self._sock is None:
            return
        try:
            self._sock.close()
        except OSError:
            pass


_client: DevdClient | None = None
_client_lock = threading.Lock()


def get_client() -> DevdClient:
    """The process-wide shared client (connect-or-spawn on first use)."""
    global _client
    with _client_lock:
        if _client is None:
            _client = DevdClient()
        return _client
