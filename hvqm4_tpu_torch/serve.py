"""Decode service on the card: the port of `hvqm4_tpu/serve.py`.

Clients submit `.h4m` clips over TCP and get back decoded frames (YUV or
RGB) or ViT embeddings. The server keeps one warm `DecoderSession` per
sequence shape (LRU-capped) on its device. Hardening: optional shared-token
auth, bounded admission (busy rejection instead of unbounded queueing: the
device is a serial resource), bounded ingress, per-connection socket
timeouts, structured metrics, graceful SIGTERM shutdown.

    python -m hvqm4_tpu_torch.serve --port 8907 [--device cuda]
                                    [--auth-token T] [--max-pending K] ...

The wire format is the JAX package's, byte for byte, so either package's
clients talk to either package's server (`tests/test_torch_host.py`).
All integers are little-endian u32:

    request:  [4: magic 'H4MQ'][4: mode][4: clip_len][clip bytes]
    authed:   [4: magic 'H4MA'][4: token_len][token]
              [4: mode][4: clip_len][clip bytes]
              mode 0 = YUV frames, 1 = RGB frames, 2 = ViT embeddings,
              3 = metrics snapshot (clip_len 0; no auth state mutated),
              4 = metrics in Prometheus text exposition format
    response: [4: magic 'H4MR'][4: status][4: n_chunks]
              then per chunk: [4: len][payload]
              status 0 = ok; 1 = error; 2 = busy (retry later);
              3 = auth required/failed (1/2/3: single UTF-8 chunk)

Multiplexed sessions: one connection carries many concurrent requests,
answered in completion order, so a slow clip does not block a fast one:

    session:  [4: magic 'H4MX'][4: token_len][token]  (len 0 = no auth)
    request:  [4: req_id][4: mode][4: clip_len][clip bytes]   (repeated)
              req_id 0xFFFFFFFF = goodbye (drain in-flight, close)
    response: [4: magic 'H4MS'][4: req_id][4: status][4: n_chunks]
              then chunks as above. A session-level auth failure is
              reported once with req_id 0xFFFFFFFF and the connection closes.

Requests decode on handler and mux worker threads, one at a time under the
server's lock; each `.cpu()` in `_chunks` is the point where a reply waits
for the card, and a CUDA error there becomes that request's error reply.

Continuous batching (`--batch-window-ms W --max-batch B`): a dispatcher
thread coalesces same-shape requests arriving within W ms (up to B) into
one arena `MultiStreamDecoder` run, its stream count padded to a power of
two with empty lanes. Each request still gets its own reply, byte-equal to
the unbatched server's; a corrupt clip poisons only its own stream.

Client helpers: `decode_remote(host, port, clip, mode, token=...)`,
`MuxClient(host, port, token=...)` and `fetch_metrics(host, port)`.
"""

from __future__ import annotations

import argparse
import concurrent.futures as cf
import hmac
import json
import signal
import socket
import socketserver
import struct
import sys
import threading
import time
from collections import OrderedDict

import torch

from .cli import DeviceError, _device
from .container import Demuxer
from .models.vit import ViTConfig, init_vit
from .ops.csc import frame_to_rgb
from .parallel.multistream import MultiStreamDecoder
from .pipeline import embed_frames
from .session import DecoderSession

PROG = "hvqm4_tpu_torch.serve"

MAGIC_Q = b"H4MQ"
MAGIC_A = b"H4MA"
MAGIC_R = b"H4MR"
MAGIC_X = b"H4MX"  # multiplexed session open
MAGIC_S = b"H4MS"  # multiplexed response frame

MODE_YUV, MODE_RGB, MODE_EMBED, MODE_METRICS, MODE_METRICS_PROM = 0, 1, 2, 3, 4

STATUS_OK, STATUS_ERROR, STATUS_BUSY, STATUS_AUTH = 0, 1, 2, 3

GOODBYE = 0xFFFFFFFF  # mux sentinel req_id: client done / session-level error


def _recv_exact(sock, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed mid-message")
        buf += chunk
    return buf


class _Handler(socketserver.BaseRequestHandler):
    def _reply(self, status: int, chunks: list[bytes]) -> None:
        self.request.sendall(MAGIC_R + struct.pack("<II", status, len(chunks)))
        for c in chunks:
            self.request.sendall(struct.pack("<I", len(c)) + c)

    def handle(self) -> None:  # one request per connection
        srv = self.server
        ingress = False
        t0 = time.monotonic()
        try:
            # a stalled or slow-lorising client must not pin a handler
            # thread (and its ingress buffer) forever
            self.request.settimeout(srv.socket_timeout_s)
            magic = _recv_exact(self.request, 4)
            token = b""
            if magic == MAGIC_X:
                try:
                    self._handle_mux()
                except Exception:
                    # never answer on the single-shot H4MR framing: the
                    # peer parses H4MS frames, so an injected error reply
                    # would desync its reader (e.g. an idle socket timeout)
                    srv.count("errors")
                return
            if magic == MAGIC_A:
                (tlen,) = struct.unpack("<I", _recv_exact(self.request, 4))
                if tlen > 1024:
                    raise ValueError("token too long")
                token = _recv_exact(self.request, tlen)
                magic = MAGIC_Q
            if magic != MAGIC_Q:
                raise ValueError("bad request magic")
            mode, clip_len = struct.unpack("<II",
                                           _recv_exact(self.request, 8))
            if srv.auth_token and not hmac.compare_digest(token,
                                                          srv.auth_token):
                srv.count("auth_failures")
                self._reply(STATUS_AUTH, [b"authentication required"])
                return
            if mode in (MODE_METRICS, MODE_METRICS_PROM):
                self._process(self._reply, mode, b"", t0)
                return
            if mode not in (MODE_YUV, MODE_RGB, MODE_EMBED):
                raise ValueError(f"bad mode {mode}")
            if clip_len > srv.max_clip_bytes:
                raise ValueError("clip too large")
            # ingress control: each buffered clip body costs up to
            # max_clip_bytes of RAM, so bound how many exist at once —
            # shed *before* recv so the bound covers ingress, not just decode
            ingress = srv.ingress.acquire(blocking=False)
            if not ingress:
                srv.count("busy_rejections")
                self._reply(STATUS_BUSY, [b"server busy, retry later"])
                return
            clip = _recv_exact(self.request, clip_len)
            self._process(self._reply, mode, clip, t0)
        except Exception as e:  # controlled error response, keep serving
            srv.count("errors")
            msg = str(e).encode()[:1000]
            try:
                self._reply(STATUS_ERROR, [msg])
            except OSError:
                pass
        finally:
            if ingress:
                srv.ingress.release()

    def _process(self, reply, mode: int, clip: bytes, t0: float) -> None:
        """Shared request body for the single-shot and mux paths.

        `reply(status, chunks)` owns the wire framing. Decode/validation
        failures become a STATUS_ERROR reply; reply-TRANSPORT failures
        propagate to the caller (the caller decides whether the connection
        is salvageable — the mux path kills the whole session)."""
        srv = self.server
        if mode == MODE_METRICS:
            reply(STATUS_OK, [srv.metrics_json()])
            return
        if mode == MODE_METRICS_PROM:
            reply(STATUS_OK, [srv.metrics_prometheus()])
            return
        admitted = False
        try:
            if mode not in (MODE_YUV, MODE_RGB, MODE_EMBED):
                raise ValueError(f"bad mode {mode}")
            # admission control: the device is serial; beyond 1 active +
            # max_pending waiters, shed load instead of queueing unboundedly
            admitted = srv.admission.acquire(blocking=False)
            if not admitted:
                srv.count("busy_rejections")
                reply(STATUS_BUSY, [b"server busy, retry later"])
                return
            if srv.batching:
                chunks = srv.decode_batched(clip, mode)
            else:
                chunks = srv.decode(clip, mode)
            # record before replying: a client that sees the reply must see
            # its own request in a subsequent metrics snapshot
            srv.record_success(mode, len(clip), sum(map(len, chunks)),
                               len(chunks), time.monotonic() - t0)
        except Exception as e:  # controlled error reply, keep serving
            srv.count("errors")
            reply(STATUS_ERROR, [str(e).encode()[:1000]])
            return
        finally:
            if admitted:
                srv.admission.release()
        reply(STATUS_OK, chunks)

    # -- multiplexed session ---------------------------------------------------

    def _handle_mux(self) -> None:
        """Serve one 'H4MX' session: a serial reader keeps the request stream
        in frame sync (headers + clip bodies), while each request decodes on
        a session worker and replies under a write lock in COMPLETION order.
        Admission semantics match the single-request path (shed with
        status=busy per request); ingress backpressure is exerted by simply
        not reading the next clip until a buffer slot frees (TCP flow
        control reaches the client — no bytes are dropped)."""
        srv = self.server
        wlock = threading.Lock()
        dead = threading.Event()

        def reply(req_id: int, status: int, chunks: list[bytes]) -> None:
            with wlock:
                if dead.is_set():
                    raise ConnectionError("mux session dead")
                try:
                    self.request.sendall(
                        MAGIC_S + struct.pack("<III",
                                              req_id, status, len(chunks)))
                    for c in chunks:
                        self.request.sendall(struct.pack("<I", len(c)) + c)
                except BaseException:
                    # a partially-written frame permanently desyncs the
                    # stream: kill the session instead of writing more
                    # (later replies raise above); shutdown() wakes the
                    # session reader blocked in recv
                    dead.set()
                    try:
                        self.request.shutdown(socket.SHUT_RDWR)
                    except OSError:
                        pass
                    raise

        (tlen,) = struct.unpack("<I", _recv_exact(self.request, 4))
        if tlen > 1024:
            raise ValueError("token too long")
        token = _recv_exact(self.request, tlen)
        if srv.auth_token and not hmac.compare_digest(token, srv.auth_token):
            srv.count("auth_failures")
            reply(GOODBYE, STATUS_AUTH, [b"authentication required"])
            return
        srv.count("mux_sessions")
        with cf.ThreadPoolExecutor(max_workers=srv.mux_workers) as ex:
            while True:
                try:
                    hdr = _recv_exact(self.request, 12)
                except OSError:
                    # clean close between frames == implicit goodbye; also
                    # covers an idle socket timeout (TimeoutError) and the
                    # reply-failure shutdown above — none of which may leak
                    # to handle() (it would inject an H4MR frame)
                    break
                req_id, mode, clip_len = struct.unpack("<III", hdr)
                if req_id == GOODBYE:
                    break  # executor __exit__ drains in-flight requests
                if clip_len > srv.max_clip_bytes:
                    # cannot skip an oversized body without buffering it;
                    # fail the request and the session (frame sync is lost)
                    srv.count("errors")
                    reply(req_id, STATUS_ERROR, [b"clip too large"])
                    break
                srv.ingress.acquire()  # blocking: backpressure via TCP
                try:
                    clip = _recv_exact(self.request, clip_len)
                except BaseException:
                    srv.ingress.release()
                    raise
                ex.submit(self._mux_one, reply, req_id, mode, clip)

    def _mux_one(self, reply, req_id: int, mode: int, clip: bytes) -> None:
        """Decode one multiplexed request (ingress slot held by caller)."""
        srv = self.server
        srv.count("mux_requests")
        try:
            self._process(lambda s, c: reply(req_id, s, c), mode, clip,
                          time.monotonic())
        except Exception:
            # reply-transport failure: reply() already marked the session
            # dead and woke the reader; nothing salvageable per-request
            srv.count("errors")
        finally:
            srv.ingress.release()


class DecodeServer(socketserver.ThreadingTCPServer):
    """The decode service on `device`. Fails at construction when the
    device is not available."""

    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, addr, device="cuda", *, max_clip_bytes: int = 256 << 20,
                 vit_cfg: ViTConfig | None = None,
                 auth_token: bytes | str = b"", max_pending: int = 8,
                 max_pixels: int = 4096 * 4096, max_sessions: int = 16,
                 socket_timeout_s: float = 120.0,
                 batch_window_s: float = 0.0, max_batch: int = 8,
                 mux_workers: int = 4):
        self.device = _device(str(device))
        super().__init__(addr, _Handler)
        self.max_clip_bytes = max_clip_bytes
        self.max_pixels = max_pixels
        self.socket_timeout_s = socket_timeout_s
        self.auth_token = (auth_token.encode()
                           if isinstance(auth_token, str) else auth_token)
        self.batching = batch_window_s > 0
        self.batch_window_s = batch_window_s
        self.max_batch = max(max_batch, 1)
        # per-session decode concurrency for multiplexed ('H4MX') clients;
        # in-flight requests beyond this queue inside the session's pool
        # (global admission still bounds actual decode concurrency)
        self.mux_workers = max(mux_workers, 1)
        # with batching, at least max_batch requests must be admissible at
        # once or batches can never fill
        slots = max(1 + max(max_pending, 0),
                    self.max_batch if self.batching else 1)
        self.admission = threading.BoundedSemaphore(slots)
        # ingress bound: active + pending + a small recv margin; each slot
        # can buffer up to max_clip_bytes, so total ingress RAM is bounded
        self.ingress = threading.BoundedSemaphore(slots + 4)
        self._sessions: OrderedDict = OrderedDict()
        self._max_sessions = max(max_sessions, 1)
        self._vit = None
        self._vit_cfg = vit_cfg
        self._lock = threading.Lock()  # one decode at a time per device
        self._mlock = threading.Lock()
        self._t_start = time.monotonic()
        self._metrics = {
            "requests_total": 0, "errors": 0, "busy_rejections": 0,
            "auth_failures": 0, "frames_served": 0, "bytes_in": 0,
            "bytes_out": 0, "latency_last_s": 0.0, "latency_sum_s": 0.0,
            "batches": 0, "batched_requests": 0, "batch_size_last": 0,
            "mux_sessions": 0, "mux_requests": 0,
            "by_mode": {"yuv": 0, "rgb": 0, "embed": 0},
        }
        self._bq: list = []
        self._bq_cond = threading.Condition()
        self._shutdown_flag = False
        if self.batching:
            threading.Thread(target=self._dispatch_loop, daemon=True,
                             name="batch-dispatcher").start()

    def shutdown(self):
        self._shutdown_flag = True
        with self._bq_cond:
            # fail queued batch waiters instead of orphaning them: their
            # handler threads hold admission/ingress slots while waiting
            for job in self._bq:
                job.error = "server shutting down"
                job.event.set()
            self._bq.clear()
            self._bq_cond.notify_all()
        super().shutdown()

    # -- metrics ---------------------------------------------------------------

    def count(self, key: str) -> None:
        with self._mlock:
            self._metrics[key] += 1

    def record_success(self, mode: int, bytes_in: int, bytes_out: int,
                       frames: int, latency_s: float) -> None:
        with self._mlock:
            m = self._metrics
            m["requests_total"] += 1
            m["frames_served"] += frames
            m["bytes_in"] += bytes_in
            m["bytes_out"] += bytes_out
            m["latency_last_s"] = round(latency_s, 6)
            m["latency_sum_s"] += latency_s
            m["by_mode"][("yuv", "rgb", "embed")[mode]] += 1

    def metrics_json(self) -> bytes:
        with self._mlock:
            m = dict(self._metrics, by_mode=dict(self._metrics["by_mode"]))
        m["uptime_s"] = round(time.monotonic() - self._t_start, 3)
        n = m["requests_total"]
        m["latency_avg_s"] = round(m.pop("latency_sum_s") / n, 6) if n else 0.0
        return json.dumps(m).encode()

    def metrics_prometheus(self) -> bytes:
        """The same snapshot in Prometheus text exposition format (scrapable
        by any standard collector; served as mode=4 / MODE_METRICS_PROM)."""
        m = json.loads(self.metrics_json())
        counters = ["requests_total", "errors", "busy_rejections",
                    "auth_failures", "frames_served", "bytes_in", "bytes_out",
                    "batches", "batched_requests", "mux_sessions",
                    "mux_requests"]
        gauges = ["latency_last_s", "latency_avg_s", "uptime_s",
                  "batch_size_last"]
        lines = []
        for key in counters:
            name = f"hvqm4_serve_{key}"
            if not name.endswith("_total"):
                name += "_total"
            lines += [f"# TYPE {name} counter", f"{name} {m[key]}"]
        for key in gauges:
            name = f"hvqm4_serve_{key}"
            lines += [f"# TYPE {name} gauge", f"{name} {m[key]}"]
        lines.append("# TYPE hvqm4_serve_requests_by_mode_total counter")
        for mode, n in m["by_mode"].items():
            lines.append(
                f'hvqm4_serve_requests_by_mode_total{{mode="{mode}"}} {n}')
        return ("\n".join(lines) + "\n").encode()

    # -- decode ----------------------------------------------------------------

    def _session(self, cfg) -> DecoderSession:
        if cfg in self._sessions:
            self._sessions.move_to_end(cfg)  # LRU refresh
        else:
            # a client can present arbitrarily many distinct (valid) shapes
            while len(self._sessions) >= self._max_sessions:
                self._sessions.popitem(last=False)
            self._sessions[cfg] = DecoderSession(cfg, self.device)
        return self._sessions[cfg]

    def _chunks(self, frames, cfg, mode) -> list[bytes]:
        """Per-frame plane lists (decode order) → mode-specific wire chunks."""
        if mode == MODE_YUV:
            return [b"".join(p.cpu().numpy().tobytes() for p in planes)
                    for planes in frames]
        if mode == MODE_RGB:
            return [frame_to_rgb(planes, cfg.h_samp, cfg.v_samp)
                    .cpu().numpy().tobytes() for planes in frames]
        # MODE_EMBED
        if self._vit is None:
            vcfg = self._vit_cfg or ViTConfig()
            self._vit = (vcfg, init_vit(vcfg, torch.Generator().manual_seed(0),
                                        self.device))
        vcfg, model = self._vit
        out = []
        for planes in frames:      # one frame a call
            emb = embed_frames(model, [p[None] for p in planes],
                               cfg.h_samp, cfg.v_samp)
            out.append(emb[0].cpu().numpy().astype("<f4").tobytes())
        return out

    def _checked_cfg(self, demux: Demuxer):
        cfg = demux.info.cfg
        # untrusted header: cap declared dimensions before any allocation
        # keyed on them
        if cfg.width * cfg.height > self.max_pixels:
            raise ValueError(
                f"frame {cfg.width}x{cfg.height} exceeds server pixel cap")
        return cfg

    def decode(self, clip: bytes, mode: int) -> list[bytes]:
        cfg = self._checked_cfg(Demuxer(clip))
        with self._lock:
            sess = self._session(cfg)
            frames = [f.planes for f in sess.decode_clip(clip)]
            return self._chunks(frames, cfg, mode)

    # -- continuous batching -----------------------------------------------------

    def decode_batched(self, clip: bytes, mode: int) -> list[bytes]:
        """Enqueue for the dispatcher; block until this request's batch ran."""
        # demux ONCE per request so a malformed clip fails HERE (or poisons
        # only its own stream later), never the whole batch
        d = Demuxer(clip)
        cfg = self._checked_cfg(d)
        records = [(r.block_index, r.frame_char, r.payload)
                   for r in d.video_records()]
        job = _BatchJob(cfg, records)
        with self._bq_cond:
            if self._shutdown_flag:
                # the dispatcher is exiting and will never drain this job
                raise RuntimeError("server shutting down")
            self._bq.append(job)
            self._bq_cond.notify_all()
        if not job.event.wait(timeout=max(self.socket_timeout_s, 600.0)):
            # withdraw an abandoned job so the dispatcher never decodes for
            # a client that already gave up
            with self._bq_cond:
                if job in self._bq:
                    self._bq.remove(job)
            raise RuntimeError("batched decode timed out")
        if job.error is not None:
            raise RuntimeError(job.error)
        with self._lock:
            return self._chunks(job.frames, cfg, mode)

    def _dispatch_loop(self) -> None:
        while not self._shutdown_flag:
            with self._bq_cond:
                while not self._bq and not self._shutdown_flag:
                    self._bq_cond.wait(timeout=0.5)
                if self._shutdown_flag:
                    return
                first = self._bq.pop(0)
            batch = [first]
            deadline = time.monotonic() + self.batch_window_s
            while len(batch) < self.max_batch:
                rem = deadline - time.monotonic()
                if rem <= 0:
                    break
                with self._bq_cond:
                    more = [j for j in self._bq if j.cfg == first.cfg]
                    for j in more[:self.max_batch - len(batch)]:
                        self._bq.remove(j)
                        batch.append(j)
                    if len(batch) < self.max_batch:
                        # block until a new enqueue (notify_all) or the
                        # window's end, even when the queue holds only
                        # other-shape jobs
                        self._bq_cond.wait(timeout=rem)
            self._run_batch(batch)

    def _run_batch(self, batch: list) -> None:
        """One `MultiStreamDecoder` run over the batch's clips; each job gets
        its frames (plane tensors on the device) or its error."""
        cfg = batch[0].cfg
        try:
            # pad the stream count to the next power of two (filler lanes
            # are empty record lists, masked from the first step): a few
            # stream counts, not one per arrival count
            n_pad = 1
            while n_pad < len(batch):
                n_pad *= 2
            lanes = [j.records for j in batch] + [[] for _ in
                                                  range(n_pad - len(batch))]
            with self._lock:
                ms = MultiStreamDecoder(cfg, [], self.device,
                                        record_lists=lanes)
                out: list[list] = [[] for _ in batch]
                for frames, _metas, valid in ms.run_pipelined():
                    for si, ok in enumerate(valid[:len(batch)]):
                        if ok:
                            out[si].append([frames[pi][si] for pi in range(3)])
            for j, s, res in zip(batch, ms.streams, out):
                if s.failed:
                    j.error = "clip failed to decode (stream poisoned)"
                else:
                    j.frames = res
                j.event.set()
            with self._mlock:
                self._metrics["batches"] += 1
                self._metrics["batched_requests"] += len(batch)
                self._metrics["batch_size_last"] = len(batch)
        except Exception as e:  # batch-level failure: fail every waiter
            for j in batch:
                j.error = str(e)
                j.event.set()


class _BatchJob:
    """One batched request: demuxed records in, per-frame planes out."""

    __slots__ = ("cfg", "records", "event", "frames", "error")

    def __init__(self, cfg, records):
        self.cfg = cfg
        self.records = records
        self.event = threading.Event()
        self.frames = None
        self.error = None


def decode_remote(host: str, port: int, clip: bytes,
                  mode: int = MODE_YUV, timeout: float = 600.0,
                  token: bytes | str = b"") -> list[bytes]:
    """Client helper: submit a clip, return response chunks.

    Raises RuntimeError on server error, BusyError on load-shed, and
    PermissionError on auth failure."""
    token = token.encode() if isinstance(token, str) else token
    with socket.create_connection((host, port), timeout=timeout) as s:
        if token:
            s.sendall(MAGIC_A + struct.pack("<I", len(token)) + token)
        else:
            s.sendall(MAGIC_Q)
        s.sendall(struct.pack("<II", mode, len(clip)) + clip)
        head = _recv_exact(s, 12)
        if head[:4] != MAGIC_R:
            raise ValueError("bad response magic")
        status, n_chunks = struct.unpack("<II", head[4:])
        chunks = []
        for _ in range(n_chunks):
            (ln,) = struct.unpack("<I", _recv_exact(s, 4))
            chunks.append(_recv_exact(s, ln))
        return _raise_for_status(status, chunks)


def _raise_for_status(status: int, chunks: list[bytes]) -> list[bytes]:
    # a conforming server always sends one UTF-8 chunk with a non-OK
    # status, but the client must not crash on a hostile/buggy peer
    msg = chunks[0].decode("utf-8", "replace") if chunks else "(no detail)"
    if status == STATUS_BUSY:
        raise BusyError(msg)
    if status == STATUS_AUTH:
        raise PermissionError(msg)
    if status != STATUS_OK:
        raise RuntimeError(f"server error: {msg}")
    return chunks


class BusyError(RuntimeError):
    """The server shed this request (admission queue full); retry later."""


class MuxClient:
    """Multiplexed decode session: many concurrent clips over ONE socket.

    `submit()` pipelines a request and returns immediately with its id;
    `result()` blocks for that id (responses complete out of order — a
    background reader thread files them). `decode()` = submit + result.
    Usable as a context manager; `close()` sends the goodbye sentinel so
    the server drains in-flight work before the socket drops."""

    def __init__(self, host: str, port: int, token: bytes | str = b"",
                 timeout: float = 600.0):
        token = token.encode() if isinstance(token, str) else token
        self._sock = socket.create_connection((host, port), timeout=timeout)
        self._sock.sendall(MAGIC_X + struct.pack("<I", len(token)) + token)
        self._next_id = 1
        self._lock = threading.Lock()       # id allocation + request writes
        self._cond = threading.Condition()  # guards _results / _reader_exc
        self._results: dict[int, tuple[int, list[bytes]]] = {}
        self._reader_exc: Exception | None = None
        self._reader = threading.Thread(target=self._read_loop, daemon=True,
                                        name="mux-reader")
        self._reader.start()

    def _read_loop(self) -> None:
        try:
            while True:
                head = _recv_exact(self._sock, 16)
                if head[:4] != MAGIC_S:
                    raise ValueError("bad mux response magic")
                req_id, status, n = struct.unpack("<III", head[4:])
                chunks = []
                for _ in range(n):
                    (ln,) = struct.unpack("<I", _recv_exact(self._sock, 4))
                    chunks.append(_recv_exact(self._sock, ln))
                if req_id == GOODBYE:  # session-level failure (e.g. auth)
                    _raise_for_status(status, chunks)
                with self._cond:
                    self._results[req_id] = (status, chunks)
                    self._cond.notify_all()
        except Exception as e:  # noqa: BLE001 - delivered to every waiter
            with self._cond:
                self._reader_exc = e
                self._cond.notify_all()

    def submit(self, clip: bytes, mode: int = MODE_YUV) -> int:
        with self._cond:
            if self._reader_exc is not None:
                raise self._reader_exc
        with self._lock:
            req_id = self._next_id
            self._next_id += 1
            self._sock.sendall(
                struct.pack("<III", req_id, mode, len(clip)) + clip)
        return req_id

    def result(self, req_id: int, timeout: float = 600.0) -> list[bytes]:
        deadline = time.monotonic() + timeout
        with self._cond:
            while req_id not in self._results:
                if self._reader_exc is not None:
                    raise self._reader_exc
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(f"mux request {req_id} timed out")
                self._cond.wait(timeout=remaining)
            status, chunks = self._results.pop(req_id)
        return _raise_for_status(status, chunks)

    def decode(self, clip: bytes, mode: int = MODE_YUV,
               timeout: float = 600.0) -> list[bytes]:
        return self.result(self.submit(clip, mode), timeout=timeout)

    def close(self, drain_timeout: float = 30.0) -> None:
        """Send the goodbye sentinel, then wait (up to `drain_timeout`) for
        the server to drain in-flight work and close its end before dropping
        the socket — closing immediately would RST the connection and turn
        the server's drained replies into write errors."""
        try:
            with self._lock:
                self._sock.sendall(struct.pack("<III", GOODBYE, 0, 0))
        except OSError:
            pass
        else:
            # the reader exits when the server, done draining, closes the
            # connection (EOF -> ConnectionError in _recv_exact)
            self._reader.join(timeout=drain_timeout)
        self._sock.close()

    def __enter__(self) -> "MuxClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def fetch_metrics(host: str, port: int, token: bytes | str = b"") -> dict:
    """Fetch the server's metrics snapshot as a dict."""
    (raw,) = decode_remote(host, port, b"", mode=MODE_METRICS, token=token)
    return json.loads(raw)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog=PROG)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8907)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda; cpu is the plain path)")
    ap.add_argument("--auth-token", default="",
                    help="require this shared token on every request")
    ap.add_argument("--max-pending", type=int, default=8,
                    help="queued requests beyond the active one before "
                         "shedding with status=busy")
    ap.add_argument("--max-pixels", type=int, default=4096 * 4096,
                    help="reject clips whose header declares more than this "
                         "many pixels per frame")
    ap.add_argument("--max-sessions", type=int, default=16,
                    help="LRU cap on cached per-shape decoder sessions")
    ap.add_argument("--socket-timeout", type=float, default=120.0,
                    help="per-connection socket timeout in seconds")
    ap.add_argument("--batch-window-ms", type=float, default=0.0,
                    help="coalesce same-shape requests arriving within this "
                         "window into one multi-stream batch (0 = off)")
    ap.add_argument("--max-batch", type=int, default=8,
                    help="max requests per coalesced batch")
    ap.add_argument("--mux-workers", type=int, default=4,
                    help="per-connection decode concurrency for multiplexed "
                         "('H4MX') sessions")
    args = ap.parse_args(argv)
    try:
        srv = DecodeServer((args.host, args.port), device=args.device,
                           auth_token=args.auth_token,
                           max_pending=args.max_pending,
                           max_pixels=args.max_pixels,
                           max_sessions=args.max_sessions,
                           socket_timeout_s=args.socket_timeout,
                           batch_window_s=args.batch_window_ms / 1000.0,
                           max_batch=args.max_batch,
                           mux_workers=args.mux_workers)
    except (DeviceError, OSError) as e:
        print(f"{PROG}: error: {e}", file=sys.stderr)
        return 1
    # shutdown() must not run on the thread blocked in serve_forever(), and
    # signal handlers run on the main thread: hand it to a helper thread
    signal.signal(signal.SIGTERM, lambda *_: threading.Thread(
        target=srv.shutdown, daemon=True).start())
    batching = (f"batch window {args.batch_window_ms} ms, max "
                f"{srv.max_batch}" if srv.batching else "no batching")
    print(f"{PROG}: decode service on {args.host}:{args.port} "
          f"(device={srv.device}, auth={'on' if args.auth_token else 'off'}, "
          f"{batching})", file=sys.stderr)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
