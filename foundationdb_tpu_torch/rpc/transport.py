"""Framed TCP transport with multiplexed request/reply endpoints.

Ref parity: fdbrpc/FlowTransport.actor.cpp: connections carry
length-prefixed packets addressed to endpoints; replies match requests
by id; a connection failure fails every outstanding request on it. A
reader thread per connection completes ``concurrent.futures`` futures,
and server handlers run on a shared pool, so a blocking endpoint (a
watch wait, a batched GRV) never stalls the socket.

Frame: 4-byte big-endian length + wire payload (rpc/wire.py).
Request: ("q", seq, method, args-tuple)  Reply: ("r", seq, ok, payload).

Authentication: with a shared ``secret`` every connection starts with a
challenge/response: the server sends a random nonce, and the client must
answer HMAC-SHA256(secret, nonce) before any request is read (ref: the
TLS handshake gating endpoint access; here a shared-secret MAC). Without
a secret the transport is open: listening on a non-loopback interface
without one exposes full read, write and management access.

``SOCKET_WRAP`` is the chaos seam: rpc/chaos.py, armed by a seed, wraps
every new client socket in its fault injector; the default path never
imports it.
"""

import hashlib
import hmac
import os
import socket
import struct
import threading
import time

from concurrent.futures import Future, ThreadPoolExecutor

from foundationdb_tpu_torch.core.errors import FDBError
from foundationdb_tpu_torch.rpc import wire
from foundationdb_tpu_torch.utils import lockdep
from foundationdb_tpu_torch.utils import span as span_mod
from foundationdb_tpu_torch.utils.trace import SEV_ERROR, TraceEvent

MAX_FRAME = 64 * 1024 * 1024
_AUTH_CONTEXT = b"fdbtpu-rpc-auth-v1:"
_AUTH_HANDSHAKE_TIMEOUT_S = 5.0
# deadline-sweep cadence: the client reader blocks in recv at most this
# long before checking outstanding requests against their deadlines, so
# a wedged peer costs one deadline + one tick, never a hung thread
_DEADLINE_TICK_S = 0.05
# consecutive deadline sweeps (with zero frames received in between)
# after which a connection is presumed black-holed rather than slow:
# callers close it and reconnect on a fresh socket instead of paying
# the full deadline again on a link that will never answer
WEDGED_STRIKE_LIMIT = 3

# Chaos transport hook (rpc/chaos.py): when armed, every NEW client
# socket is wrapped in the seeded fault injector. None on the default
# path — chaos code is never even imported unless a seed arms it via
# chaos.arm()/the rpc_chaos_seed knob/FDB_TPU_CHAOS_SEED.
SOCKET_WRAP = None


def _socket_wrap():
    global SOCKET_WRAP
    if SOCKET_WRAP is None:
        seed = os.environ.get("FDB_TPU_CHAOS_SEED")
        if seed:
            from foundationdb_tpu_torch.rpc import chaos

            chaos.arm(seed)  # sets SOCKET_WRAP
    return SOCKET_WRAP


class DeadlineExceeded(TimeoutError):
    """A request outlived its deadline; the connection itself is fine.

    The service layer maps this by RPC class: commit-class calls become
    ``commit_unknown_result`` (1021 — the txn MAY have committed),
    read/GRV/admin calls become plainly retryable errors.
    """

    def __init__(self, method, deadline_s, address=""):
        super().__init__(
            f"rpc {method!r} to {address or '?'} exceeded its "
            f"{deadline_s:.3f}s deadline"
        )
        self.method = method
        self.deadline_s = deadline_s
        self.address = address


def _auth_proof(secret, nonce):
    if isinstance(secret, str):
        secret = secret.encode()
    return hmac.new(secret, _AUTH_CONTEXT + nonce, hashlib.sha256).digest()


class ConnectionLost(ConnectionError):
    """The peer vanished with requests outstanding."""


def _send_frame(sock, lock, payload: bytes):
    if len(payload) > MAX_FRAME:
        raise ValueError(f"frame too large: {len(payload)}")
    msg = struct.pack(">I", len(payload)) + payload
    with lock:
        # this per-socket lock EXISTS to serialize whole-frame sends —
        # interleaved partial frames would corrupt the stream; nothing
        # else is ever guarded by it, so no convoy can form
        sock.sendall(msg)  # flowlint: disable=FL003


def _recv_exact(sock, n):
    parts = []
    while n:
        chunk = sock.recv(n)
        if not chunk:
            raise ConnectionLost("peer closed")
        parts.append(chunk)
        n -= len(chunk)
    return b"".join(parts)


def _recv_frame(sock):
    (n,) = struct.unpack(">I", _recv_exact(sock, 4))
    if n > MAX_FRAME:
        raise ConnectionLost(f"oversized frame: {n}")
    return _recv_exact(sock, n)


class _FrameReader:
    """Buffered frame reader that survives ``socket.timeout`` mid-frame.

    The client reader runs its socket with a short timeout so it can
    sweep request deadlines between frames. ``_recv_exact`` would LOSE
    partially-received bytes on a timeout and desync the stream; this
    reader keeps partial state across ticks, so a timeout is always a
    clean "nothing complete yet — go sweep" signal.
    """

    def __init__(self, sock):
        self._sock = sock
        self._buf = bytearray()
        self._need = None  # payload length once the header is parsed

    def recv_frame(self):
        while True:
            if self._need is None and len(self._buf) >= 4:
                (n,) = struct.unpack(">I", bytes(self._buf[:4]))
                if n > MAX_FRAME:
                    raise ConnectionLost(f"oversized frame: {n}")
                del self._buf[:4]
                self._need = n
            if self._need is not None and len(self._buf) >= self._need:
                payload = bytes(self._buf[: self._need])
                del self._buf[: self._need]
                self._need = None
                return payload
            chunk = self._sock.recv(65536)  # may raise socket.timeout
            if not chunk:
                raise ConnectionLost("peer closed")
            self._buf += chunk


class RpcServer:
    """Listens for connections; dispatches requests to named handlers.

    ``handlers`` is the endpoint table: method name → callable(*args).
    A handler raising FDBError sends the error to the client intact
    (the client re-raises it); any other exception becomes a generic
    remote failure string.
    """

    def __init__(self, host, port, handlers, max_workers=16,
                 long_methods=(), secret=None):
        self.secret = secret
        self.handlers = dict(handlers)
        # endpoints that legitimately block (watch waits) run on their
        # own pool so parked waiters cannot starve short RPCs
        self.long_methods = set(long_methods)
        self._listener = socket.create_server(
            (host, port), reuse_port=False, backlog=64
        )
        self._listener.settimeout(0.2)
        self.host, self.port = self._listener.getsockname()[:2]
        self._pool = ThreadPoolExecutor(
            max_workers=max_workers, thread_name_prefix="rpc-handler"
        )
        self._long_pool = (
            ThreadPoolExecutor(
                max_workers=256, thread_name_prefix="rpc-blocking"
            )
            if self.long_methods
            else None
        )
        self._conns = set()
        self._lock = lockdep.lock("RpcServer._lock")
        self._closed = threading.Event()
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="rpc-accept", daemon=True
        )
        self._accept_thread.start()

    @property
    def address(self):
        return f"{self.host}:{self.port}"

    def add_handlers(self, handlers, long_methods=()):
        """Register more endpoints on a live server (an fdbserver process
        brings its coordinator endpoints up first so peers can reach the
        quorum, then attaches the cluster service after recovery).

        Long-method routing is installed BEFORE the handlers become
        callable: a blocking endpoint must never be reachable while it
        would still dispatch onto the short-RPC pool."""
        new_long = set(long_methods) - self.long_methods
        if new_long:
            if self._long_pool is None:
                self._long_pool = ThreadPoolExecutor(
                    max_workers=256, thread_name_prefix="rpc-blocking"
                )
            self.long_methods |= new_long
        self.handlers.update(handlers)

    def _accept_loop(self):
        while not self._closed.is_set():
            try:
                sock, peer = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._lock:
                self._conns.add(sock)
            threading.Thread(
                target=self._serve_conn, args=(sock, peer),
                name=f"rpc-conn-{peer}", daemon=True,
            ).start()

    def _authenticate(self, sock, send_lock, peer):
        """Challenge/response before the first request frame. The
        handshake runs under a timeout so an idle port-scanner cannot
        park a connection thread forever."""
        # crypto material must NOT come from the seeded determinism
        # registry: a replayable nonce is a replayable handshake
        nonce = os.urandom(16)  # flowlint: disable=FL001
        _send_frame(sock, send_lock, nonce)
        sock.settimeout(_AUTH_HANDSHAKE_TIMEOUT_S)
        try:
            # pre-auth frames are capped at the proof size (32 bytes):
            # an unauthenticated peer must not be able to make us buffer
            # a MAX_FRAME allocation before the HMAC check rejects it
            (n,) = struct.unpack(">I", _recv_exact(sock, 4))
            if n > 64:
                raise ConnectionLost(f"oversized auth proof: {n}")
            proof = _recv_exact(sock, n)
        finally:
            sock.settimeout(None)
        if not hmac.compare_digest(proof, _auth_proof(self.secret, nonce)):
            TraceEvent("RpcAuthFailed", severity=30).detail(
                peer=str(peer)).log()
            raise ConnectionLost("authentication failed")
        # confirmation frame: the client learns its proof was accepted
        # before sending requests, so a secret mismatch surfaces as a
        # deterministic handshake failure, not a later dead socket
        _send_frame(sock, send_lock, b"\x00ok")

    def _serve_conn(self, sock, peer):
        send_lock = lockdep.lock("RpcServer._serve_conn.send_lock")
        try:
            if self.secret is not None:
                self._authenticate(sock, send_lock, peer)
            while not self._closed.is_set():
                frame = _recv_frame(sock)
                msg = wire.loads(frame)
                # protocol v5: an optional TRACING frame rides as a 5th
                # element (the caller's SpanContext); shorter tuples are
                # the untraced form — peers ignore what isn't there
                kind, seq, method, args = msg[0], msg[1], msg[2], msg[3]
                trace_ctx = msg[4] if len(msg) > 4 else None
                if kind != "q":
                    raise ConnectionLost(f"unexpected message kind {kind!r}")
                pool = (
                    self._long_pool
                    if self._long_pool is not None
                    and method in self.long_methods
                    else self._pool
                )
                pool.submit(
                    self._dispatch, sock, send_lock, seq, method, args,
                    trace_ctx,
                )
        except (ConnectionLost, ConnectionError, OSError, ValueError):
            pass
        finally:
            with self._lock:
                self._conns.discard(sock)
            try:
                sock.close()
            except OSError:
                pass

    def _dispatch(self, sock, send_lock, seq, method, args,
                  trace_ctx=None):
        prior_ctx = None
        if trace_ctx is not None:
            # install the caller's SpanContext as this handler thread's
            # ambient context: role code (grv grant, storage reads)
            # opens child spans off span.current() without every
            # handler signature growing a tracing parameter
            prior_ctx = span_mod.set_current(tuple(trace_ctx))
        try:
            fn = self.handlers.get(method)
            if fn is None:
                raise KeyError(f"no such endpoint: {method}")
            result = fn(*args)
            reply = wire.dumps(("r", seq, True, result))
        except FDBError as e:
            reply = wire.dumps(("r", seq, False, e))
        except Exception as e:  # generic remote failure
            # the client only receives a flattened string — the server
            # trace is the record with the real type and context
            TraceEvent("RpcHandlerError", severity=SEV_ERROR).detail(
                method=method, etype=type(e).__name__,
                error=str(e)[:200]).log()
            reply = wire.dumps(("r", seq, False, f"{type(e).__name__}: {e}"))
        finally:
            if trace_ctx is not None:
                span_mod.set_current(prior_ctx)
        try:
            _send_frame(sock, send_lock, reply)
        except (ConnectionError, OSError):
            pass  # client vanished; nothing to tell it
        except ValueError:
            # reply exceeds MAX_FRAME: the client must still get an answer
            # or its future hangs forever — send the error instead
            try:
                _send_frame(sock, send_lock, wire.dumps((
                    "r", seq, False,
                    f"ValueError: reply to {method} exceeds frame limit",
                )))
            except (ConnectionError, OSError, ValueError):
                pass

    def close(self):
        self._closed.set()
        try:
            self._listener.close()
        except OSError:
            pass
        with self._lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass
        self._pool.shutdown(wait=False)
        if self._long_pool is not None:
            self._long_pool.shutdown(wait=False)
        self._accept_thread.join(timeout=2)


class RemoteError(RuntimeError):
    """A non-FDBError exception raised inside a remote handler."""


class RpcClient:
    """One connection to an RpcServer; thread-safe, multiplexed calls."""

    def __init__(self, host, port, connect_timeout=5.0, secret=None):
        self.host, self.port = host, port
        self._sock = socket.create_connection((host, port), connect_timeout)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        wrap = _socket_wrap()
        if wrap is not None:
            self._sock = wrap(self._sock, f"{host}:{port}")
        self._send_lock = lockdep.lock("RpcClient._send_lock")
        if secret is not None:
            # the server's first frame is the auth nonce; answer before
            # the reader thread starts interpreting frames as replies
            self._sock.settimeout(_AUTH_HANDSHAKE_TIMEOUT_S)
            try:
                nonce = _recv_frame(self._sock)
                _send_frame(self._sock, self._send_lock,
                            _auth_proof(secret, nonce))
                if _recv_frame(self._sock) != b"\x00ok":
                    raise ConnectionLost("bad auth confirmation")
                self._sock.settimeout(None)
            except (OSError, ConnectionLost) as e:
                # a server not configured for auth never sends a nonce:
                # fail fast with the real cause (and no leaked socket)
                # instead of surfacing as generic unreachability
                try:
                    self._sock.close()
                except OSError:
                    pass
                raise ConnectionLost(
                    f"auth handshake with {host}:{port} failed — secret "
                    f"mismatch or server not configured for auth: {e!r}"
                ) from e
        self._state_lock = lockdep.lock("RpcClient._state_lock")
        # seq -> (Future, expires_monotonic|None, method, deadline_s)
        self._pending = {}
        self._seq = 0
        self._closed = False
        # consecutive deadline expiries with NO intervening reply: a
        # black-holed link looks exactly like a slow one, so callers use
        # this to stop re-paying full deadlines on a dead connection
        # (see WEDGED_STRIKE_LIMIT). Single int under the GIL; the
        # reader thread writes, callers only compare against the limit.
        # flowlint: shared(GIL-atomic counter; a stale read delays one reconnect)
        self.deadline_strikes = 0
        # monotonic stamp of the last frame sent or received: the
        # keepalive pinger only probes links that have gone quiet (one
        # float store under the GIL; a stale read delays one ping)
        # flowlint: shared(GIL-atomic heartbeat; staleness is benign)
        self.last_activity = time.monotonic()
        self._reader = threading.Thread(
            target=self._read_loop, name="rpc-client-reader", daemon=True
        )
        self._reader.start()

    def _read_loop(self):
        reader = _FrameReader(self._sock)
        try:
            # short recv timeout = the deadline-sweep tick; a wedged or
            # silent peer can no longer park this thread forever
            self._sock.settimeout(_DEADLINE_TICK_S)
            while True:
                try:
                    frame = reader.recv_frame()
                except socket.timeout:
                    self._sweep_deadlines()
                    continue
                self.last_activity = time.monotonic()
                self.deadline_strikes = 0  # the link demonstrably moves data
                kind, seq, ok, payload = wire.loads(frame)
                with self._state_lock:
                    entry = self._pending.pop(seq, None)
                if entry is None:
                    continue  # cancelled/timed-out request
                fut = entry[0]
                if fut.done():
                    continue  # already deadline-settled
                if ok:
                    fut.set_result(payload)
                elif isinstance(payload, FDBError):
                    fut.set_exception(payload)
                else:
                    fut.set_exception(RemoteError(str(payload)))
        except (ConnectionLost, ConnectionError, OSError, ValueError) as e:
            self._fail_all(e)

    def _sweep_deadlines(self):
        """Settle every request past its deadline with DeadlineExceeded.

        The connection stays up: a slow reply to a swept seq is dropped
        by the reader, and unexpired requests keep waiting. Futures are
        settled outside the state lock (callbacks may block)."""
        now = time.monotonic()
        expired = []
        with self._state_lock:
            for seq, entry in list(self._pending.items()):
                expires = entry[1]
                if expires is not None and now >= expires:
                    expired.append(entry)
                    del self._pending[seq]
        if expired:
            self.deadline_strikes += 1
        for fut, _expires, method, deadline_s in expired:
            if not fut.done():
                fut.set_exception(DeadlineExceeded(
                    method, deadline_s,
                    address=f"{self.host}:{self.port}",
                ))

    def _fail_all(self, exc):
        with self._state_lock:
            self._closed = True
            pending, self._pending = self._pending, {}
        try:
            self._sock.close()  # no fd leak across reconnect cycles
        except OSError:
            pass
        for entry in pending.values():
            fut = entry[0]
            if not fut.done():
                fut.set_exception(ConnectionLost(str(exc)))

    @property
    def alive(self):
        return not self._closed

    def call_async(self, method, *args, deadline_s=None) -> Future:
        fut = Future()
        expires = (
            time.monotonic() + deadline_s if deadline_s is not None else None
        )
        with self._state_lock:
            if self._closed:
                raise ConnectionLost("connection closed")
            self._seq += 1
            seq = self._seq
            self._pending[seq] = (fut, expires, method, deadline_s)
        # the thread's ambient SpanContext (a sampled client span) rides
        # as the optional v5 tracing frame; untraced calls keep the
        # 4-tuple form byte-for-byte
        ctx = span_mod.current()
        msg = ("q", seq, method, tuple(args)) if ctx is None \
            else ("q", seq, method, tuple(args), ctx)
        try:
            _send_frame(self._sock, self._send_lock, wire.dumps(msg))
            self.last_activity = time.monotonic()
        except (ConnectionError, OSError) as e:
            with self._state_lock:
                self._pending.pop(seq, None)
            self._fail_all(e)
            raise ConnectionLost(str(e)) from e
        except (ValueError, TypeError):
            # encoding failure / oversized request: the connection is fine,
            # only this call is bad — don't fail other in-flight requests
            with self._state_lock:
                self._pending.pop(seq, None)
            raise
        return fut

    def call(self, method, *args, timeout=None, deadline_s=None):
        return self.call_async(
            method, *args, deadline_s=deadline_s
        ).result(timeout=timeout)

    def close(self):
        with self._state_lock:
            self._closed = True
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        # the shutdown above unblocks the reader's recv; join so close()
        # returns with no thread still touching the dead socket
        if self._reader is not threading.current_thread():
            self._reader.join(timeout=5)


def connect_any(addresses, connect_timeout=5.0, secret=None):
    """Try each ``host:port`` in turn; first reachable wins (ref: the
    client walking the coordinator list in the cluster file)."""
    last = None
    for addr in addresses:
        host, _, port = addr.rpartition(":")
        try:
            return RpcClient(host, int(port), connect_timeout, secret=secret)
        except OSError as e:
            last = e
    raise ConnectionLost(
        f"no server reachable among {addresses!r}: {last}"
    )
