"""The device-server daemon: one warm session, many CLI runs.

Run as ``python -m phylonium_tpu.serve``; the CLI engages it only under
``PHYLONIUM_TPU_DEVD=1`` and never opens the card itself then.  Binds a
unix socket (default ``<checkout>/.state/devd.sock``, override
``PHYLONIUM_TPU_DEVD_SOCK``), initializes the device in the background
(the per-process start-up cost lands HERE, once), and then serves:

    ping                                -> {ok, warm, platform, pid}
    qgroup  {run, gidx} + [packed, sep] -> verified device residency
    group   {run, gen, seq, gidx?, ref_len, l2, width}
            + [intervals] (+ [packed, sep] when not pre-shipped)
                                        -> enqueues one pileup row-chunk
                                           build (per-run worker thread;
                                           raw codes are shipped +
                                           residency-verified before the
                                           reply, the BUILD is not — a
                                           first-shape compile must
                                           never stall the client's
                                           mapping loop)
    finish  {run, n}                    -> joins the build queue, counts
                                           on the resident chunks;
                                           replies [subs, homs]
    cancel  {run}                       -> drops the run's device state

One client connection is served at a time (CLI runs are sequential);
all state is per-connection and dropped when the client disconnects, so
a crashed CLI can never leak panels into the next run.  Replies to
qgroup (and the raw-codes ship inside group) are sent only after a
sync-probed fetch proves residency — the client's shipped accounting
stays honest.  Build failures surface at finish; device failures answer
``{ok: false, error: ...}``; the daemon itself stays up (the client's
host race absorbs the miss).  Exits after 30 idle minutes
(``PHYLONIUM_TPU_DEVD_IDLE_S``).
"""

from __future__ import annotations

import os
import socket
import sys
import threading
import time

import numpy as np

from phylonium_tpu.serve.wire import WireError, recv_msg, send_msg

# bumped on every protocol / device-program change: a daemon left over
# from an older build answers ping with its own stamp and the client
# replaces it instead of hitting unknown ops or stale kernels
PROTOCOL = "phyd-9"


def sock_path() -> str:
    env = os.environ.get("PHYLONIUM_TPU_DEVD_SOCK")
    if env:
        return env
    from phylonium_tpu.utils.cache import state_dir

    path = os.path.join(state_dir(), "devd.sock")
    if len(path) > 100:  # AF_UNIX path limit: fall back to $TMPDIR
        import hashlib
        import tempfile

        tag = hashlib.sha1(path.encode()).hexdigest()[:12]
        path = os.path.join(tempfile.gettempdir(), f"phylonium-{tag}.sock")
    return path


class _State:
    def __init__(self):
        self.warm = False
        self.platform = None
        # per-run device state: run -> {"groups": {gidx: (pd, sd)},
        #                               "chunks": {seq: chunk}}
        self.runs: dict = {}
        # content-addressed query-group cache, ACROSS connections:
        # identical query groups (re-runs of a panel, a -2 second pass,
        # bootstrap sweeps) ship ONCE per daemon lifetime.
        # key -> (packed_dev, nbytes); LRU-capped.
        self.qcache: dict = {}
        self.qcache_bytes = 0
        self.qcache_cap = int(
            float(os.environ.get("PHYLONIUM_TPU_DEVD_CACHE_MB", 4096))
            * 1e6
        )

    def qcache_put(self, key: str, pd, nbytes: int) -> None:
        if key in self.qcache:
            return
        while self.qcache and self.qcache_bytes + nbytes > self.qcache_cap:
            old, (_, old_bytes) = next(iter(self.qcache.items()))
            del self.qcache[old]
            self.qcache_bytes -= old_bytes
        self.qcache[key] = (pd, nbytes)
        self.qcache_bytes += nbytes

    def qcache_get(self, key: str):
        hit = self.qcache.pop(key, None)
        if hit is not None:
            self.qcache[key] = hit  # LRU refresh
        return hit

    def probe_sync(self, arr) -> None:
        """Wait until ``arr`` is resident on the device."""
        import jax

        jax.block_until_ready(arr)


def _run_builder(state: _State, run: str, st: dict):
    """The run's build queue (lazily started worker thread).

    Group builds execute off the connection thread so a `group` reply
    can return before the (possibly minutes-long, first-shape) compile
    inside the build program: the client's mapping loop keeps feeding,
    and `finish` joins the queue before counting."""
    import queue as _queue

    bq = st.get("bq")
    if bq is None:
        bq = st["bq"] = _queue.Queue()

        def work():
            # the import itself can fail (a partial install): record it as a build error and KEEP draining
            # the queue — a dead worker that stops calling task_done
            # would block finish()'s join forever
            build = None
            try:
                from phylonium_tpu.ops.pileup_device import (
                    dispatch_build_packed as build,
                )
            except Exception as e:  # noqa: BLE001
                st["berror"] = repr(e)[:500]
            while True:
                item = bq.get()
                try:
                    if item is None:
                        return
                    if st.get("cancelled") or st.get("berror"):
                        continue
                    if (
                        os.environ.get("PHYLONIUM_TPU_DEVD_INJECT")
                        == "slow_build"
                    ):
                        # fault injection (tests): a first-shape compile
                        # inside the build program
                        time.sleep(3.0)
                    header, arrays = item
                    if header.get("gidx") is not None:
                        pd = st["groups"][int(header["gidx"])]
                        intervals, orow, ocol, oval = arrays
                    else:
                        pd, intervals, orow, ocol, oval = arrays
                    chunk = build(
                        pd, intervals, (orow, ocol, oval),
                        int(header["ref_len"]), int(header["l2"]),
                        int(header["width"]),
                    )
                    st["chunks"][int(header["seq"])] = chunk
                except Exception as e:  # noqa: BLE001 — at finish
                    st["berror"] = repr(e)[:500]
                finally:
                    bq.task_done()

        threading.Thread(
            target=work, daemon=True, name=f"devd-build-{run[:12]}"
        ).start()
    return bq


def _warmup(state: _State) -> None:
    try:
        from phylonium_tpu.core.query_ship import warm_link
        from phylonium_tpu.utils.platform import device_setup

        device_setup()
        import jax

        state.platform = jax.devices()[0].platform
        warm_link()
        state.warm = True
    except Exception as e:  # noqa: BLE001 — daemon stays up, unwarm
        sys.stderr.write(f"devd: warmup failed: {e!r}\n")


def _handle(state: _State, header: dict, arrays: list):
    """One request -> (reply_header, reply_arrays)."""
    op = header.get("op")
    if op == "ping":
        return {
            "ok": True,
            "warm": state.warm,
            "platform": state.platform,
            "pid": os.getpid(),
            "protocol": PROTOCOL,
            "qcache_mb": round(state.qcache_bytes / 1e6, 1),
            "qcache_groups": len(state.qcache),
        }, []

    if op == "probe":
        # verified link-bandwidth probe through the warm session
        mb = int(header.get("mb", 16))
        rng = np.random.default_rng(int(header.get("seed", 0)))
        data = rng.integers(0, 256, mb << 20).astype(np.uint8)
        import jax

        t0 = time.time()
        d = jax.device_put(data)
        state.probe_sync(d)
        dt = time.time() - t0
        return {
            "ok": True,
            "seconds": dt,
            "mb_s": round(mb / dt, 2) if dt > 0 else None,
        }, []

    import jax

    if op == "qhave":
        # content-cache lookup: a hit binds the cached device arrays to
        # this run's group slot with ZERO bytes shipped
        run, gidx, key = header["run"], int(header["gidx"]), header["key"]
        hit = state.qcache_get(key)
        if hit is None:
            return {"ok": True, "have": False}, []
        pd, _ = hit
        groups = state.runs.setdefault(
            run, {"groups": {}, "chunks": {}}
        )["groups"]
        groups[gidx] = pd
        return {"ok": True, "have": True}, []

    if op == "qgroup":
        run, gidx = header["run"], int(header["gidx"])
        (packed,) = arrays
        t0 = time.time()
        pd = jax.device_put(packed)
        state.probe_sync(pd)
        groups = state.runs.setdefault(
            run, {"groups": {}, "chunks": {}}
        )["groups"]
        groups[gidx] = pd
        if header.get("key"):
            state.qcache_put(header["key"], pd, packed.nbytes)
        return {"ok": True, "seconds": time.time() - t0}, []

    if op == "group":
        run = header["run"]
        st = state.runs.setdefault(run, {"groups": {}, "chunks": {}})
        # a -2 second pass reuses the run id (so its qgroups stay
        # resident) but sends a fresh generation token: reset the
        # builder state once per generation — a stale pass-1 cancel or
        # build error must not kill pass 2, while WITHIN a pass a build
        # error stays sticky (clearing it mid-pass would let finish
        # count a silently partial chunk set)
        gen = header.get("gen")
        if gen is not None and st.get("gen") != gen:
            st["gen"] = gen
            st.pop("cancelled", None)
            st.pop("berror", None)
            st["chunks"] = {}
        t0 = time.time()
        if header.get("gidx") is None:
            # raw codes arrive with this group (no qgroup/qhave ride):
            # ship them NOW so the reply stays the verified-residency
            # signal the client's link accounting relies on
            intervals, orow, ocol, oval, packed = arrays
            pd = jax.device_put(packed)
            state.probe_sync(pd)
            item = (header, (pd, intervals, orow, ocol, oval))
        else:
            item = (header, arrays)
        # the BUILD is queued to the run's worker thread and the reply
        # returns immediately: a first-shape compile inside the build
        # program must never stall the client's mapping loop — the
        # bounded-backlog lowmem feeder gives up on exactly that.
        # finish() joins the queue; a failed build surfaces there (the
        # host race records it).
        _run_builder(state, run, st).put(item)
        return {"ok": True, "seconds": time.time() - t0}, []

    if op == "finish":
        from phylonium_tpu.ops.device_counts import pair_counts_chunks

        run = header["run"]
        st = state.runs.get(run)
        if st is None:
            return {"ok": False, "error": f"no chunks for run {run}"}, []
        if st.get("bq") is not None:
            st["bq"].join()  # every queued build dispatched (or failed)
        if st.get("berror"):
            err, st["berror"] = st["berror"], None
            st["chunks"] = {}
            return {"ok": False, "error": f"group build failed: {err}"}, []
        if not st["chunks"]:
            return {"ok": False, "error": f"no chunks for run {run}"}, []
        chunks = tuple(
            st["chunks"][k] for k in sorted(st["chunks"])
        )
        # chunks are consumed; qgroups stay (a -2 second pass reuses
        # the same resident query codes under the same run id)
        st["chunks"] = {}
        n = int(header["n"])
        t0 = time.time()
        subs, homs = pair_counts_chunks(chunks, n, packed=True)
        # the daemon-side count time (forces the async chunk builds,
        # runs the kernels, fetches the counts) — the client's race
        # observability separates socket/wait time from device time.
        # Also logged: a race-abandoned finish never reaches a client,
        # and its duration is the post-mortem for a lost race.
        dt = round(time.time() - t0, 3)
        if os.environ.get("PHYLONIUM_TPU_DEVD_LOG_FINISH", "1") != "0":
            sys.stderr.write(
                f"devd: finish n={n} chunks={len(chunks)} {dt}s\n"
            )
        return {"ok": True, "seconds": dt}, [subs, homs]

    if op == "cancel":
        st = state.runs.get(header.get("run"))
        if st is not None:
            st["cancelled"] = True  # builder skips queued items
            st["chunks"] = {}  # qgroups stay for a later pass
        return {"ok": True}, []

    if op == "prewarm":
        # compile (and persist) the streamed program family for this
        # panel shape.  sync=true (the cold-run drain's seeding hook,
        # pipeline._compare_and_finish) blocks until the daemon's
        # in-memory jit cache is hot for this shape, so the NEXT run's
        # device leg races with zero compiles; otherwise the compile
        # runs in the BACKGROUND and group builds arriving on this
        # connection meanwhile only need device_put + the tiny probe
        gr = header.get("group_rows")
        gr = int(gr) if gr else None
        if header.get("sync"):
            from phylonium_tpu.core.stream import prewarm_panel

            t0 = time.time()
            prewarm_panel(
                int(header["n"]), int(header["ref_len"]), group_rows=gr
            )
            return {
                "ok": True, "seconds": round(time.time() - t0, 2),
            }, []

        def _warm():
            try:
                from phylonium_tpu.core.stream import prewarm_panel

                prewarm_panel(
                    int(header["n"]), int(header["ref_len"]),
                    group_rows=gr,
                )
            except Exception as e:  # noqa: BLE001
                sys.stderr.write(f"devd: prewarm failed: {e!r}\n")

        threading.Thread(target=_warm, daemon=True).start()
        return {"ok": True}, []

    return {"ok": False, "error": f"unknown op {op!r}"}, []


def serve(path: str | None = None, idle_s: float | None = None) -> int:
    # platform pin BEFORE any request can touch a backend: a request
    # racing the warmup thread must never init an unpinned backend
    # (PHYLONIUM_TPU_PLATFORM=cpu daemons exist — tests)
    from phylonium_tpu.utils.platform import apply_platform_override

    apply_platform_override()

    path = path or sock_path()
    if idle_s is None:
        idle_s = float(os.environ.get("PHYLONIUM_TPU_DEVD_IDLE_S", 1800))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    # never bind over a LIVE daemon: rebinding unlinks its socket and
    # orphans its warm session + content cache (observed: a spawn
    # cascade while daemon warmup held the GIL — each refused client
    # spawned a fresh cold daemon over the warming one)
    try:
        with open(path + ".pid") as f:
            other = int(f.read().strip())
        if other != os.getpid():
            os.kill(other, 0)  # raises if dead
            sys.stderr.write(
                f"devd: pid {other} already serves {path}; exiting\n"
            )
            return 0
    except (OSError, ValueError):
        pass
    try:
        os.unlink(path)
    except OSError:
        pass
    srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    srv.bind(path)
    os.chmod(path, 0o600)
    # deep backlog: during the (GIL-heavy) warmup the accept loop can
    # stall for a while; queued clients must wait, not be refused (a
    # refused client would try to spawn a replacement)
    srv.listen(128)
    srv.settimeout(10.0)
    with open(path + ".pid", "w") as f:
        f.write(str(os.getpid()))

    state = _State()
    threading.Thread(target=_warmup, args=(state,), daemon=True).start()
    sys.stderr.write(f"devd: serving on {path} (pid {os.getpid()})\n")

    activity = {"t": time.time()}
    try:
        while True:
            try:
                conn, _ = srv.accept()
            except socket.timeout:
                if time.time() - activity["t"] > idle_s:
                    sys.stderr.write("devd: idle timeout, exiting\n")
                    return 0
                continue
            activity["t"] = time.time()
            # one thread per connection: control ops (ping, qhave,
            # cancel) stay responsive while another client's device op
            # runs, and a dead client's
            # half-open connection can never wedge the accept loop
            threading.Thread(
                target=_serve_conn,
                args=(state, conn, activity),
                daemon=True,
            ).start()
    finally:
        srv.close()
        for suffix in ("", ".pid"):
            try:
                os.unlink(path + suffix)
            except OSError:
                pass


def _serve_conn(state: _State, conn: socket.socket, activity) -> None:
    touched: set = set()  # run ids created over THIS connection
    try:
        while True:
            try:
                header, arrays = recv_msg(conn)
            except (WireError, OSError):
                return  # client gone
            activity["t"] = time.time()
            if isinstance(header.get("run"), str):
                touched.add(header["run"])
            try:
                reply, out = _handle(state, header, arrays)
            except Exception as e:  # noqa: BLE001 — stay up
                reply, out = {"ok": False, "error": repr(e)[:500]}, []
            try:
                send_msg(conn, reply, out)
            except OSError:
                return
            activity["t"] = time.time()
    finally:
        conn.close()
        for run in touched:  # per-connection state, never leaks
            st = state.runs.pop(run, None)
            if st is not None and st.get("bq") is not None:
                # skip still-queued builds (nobody will count them, and
                # their compiles would steal host cores from the NEXT
                # run), then let the builder thread exit
                st["cancelled"] = True
                st["bq"].put(None)


if __name__ == "__main__":
    sys.exit(serve())
