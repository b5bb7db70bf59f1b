"""Production star transport: king/client TCP (optionally mTLS) with
timeout + threshold + surviving-parties fault tolerance.

The port's own copy of zksaas_tpu/comm/star.py (the byte layer is stdlib
only, and the wire format is the same byte for byte, so a king of one
package serves clients of the other).  The analog of the reference's
ProdNet (mpc-net/src/prod.rs): a *pure star* — the king binds and accepts
n-1 mutually-authenticated clients; clients hold exactly one connection
(prod.rs:119-184).  Frames are length-prefixed with a (channel, party)
header — the channel id is the 3-way stream multiplexing
(MultiplexedStreamID, lib.rs:43-53) collapsed onto one socket with a
demux thread.  A Syn/SynAck barrier follows connection setup
(synchronize, prod.rs:246-296).

Fault-tolerance contract (lib.rs:89-136 + ser_net.rs:16-99):
gather-to-king waits up to `timeout` per round; missing parties yield a
Partial result carrying the surviving-party list, and fewer than
`threshold` responses raises — exactly ReceivedShares{shares, parties}.

This layer moves raw bytes; HostStarNet in host_net.py adapts it to the
protocol `round` interface with numpy serialization.  mTLS uses pinned
self-signed certs (gen_cert analog in make_self_signed_cert, which imports
the `cryptography` package only when it is called).
"""

from __future__ import annotations

import socket
import ssl
import struct
import threading
import time
from dataclasses import dataclass
from queue import Empty, Queue

_HDR = struct.Struct("<IIQ")  # channel, party, length
_SYN = b"\x01SYN"
_SYNACK = b"\x02ACK"
# Reserved control channel for the Syn/SynAck barrier: SYNs RETRANSMIT
# until acked (under load, a TLS 1.3 client finishes its handshake one
# round-trip before the server and its first record can sit unread
# through the server-side wrap — observed as a lost first SYN), so
# duplicates must be routable away from protocol data channels.
_CTRL = 0xFFFFFFFF


@dataclass
class ReceivedBytes:
    """ser_net.rs ReceivedShares analog at the byte layer."""

    shares: list  # bytes or None per party index
    parties: tuple

    @property
    def is_full(self) -> bool:
        return all(s is not None for s in self.shares)


class _Demux:
    """Per-connection receiver thread feeding (channel -> queue), or —
    when `sink` is given — a single shared queue of (channel, party,
    body) tuples (the king funnels all n-1 links into one inbox so a
    gather blocks on ONE queue instead of polling every link)."""

    def __init__(self, sock: socket.socket, sink: Queue | None = None):
        self.sock = sock
        self.sink = sink
        self.queues: dict[int, Queue] = {}
        self.lock = threading.Lock()
        self.dead = False
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _q(self, channel: int) -> Queue:
        with self.lock:
            if channel not in self.queues:
                self.queues[channel] = Queue()
            return self.queues[channel]

    def _run(self):
        try:
            while True:
                hdr = self._read_exact(_HDR.size)
                if hdr is None:
                    break
                channel, party, length = _HDR.unpack(hdr)
                body = self._read_exact(length)
                if body is None:
                    break
                if self.sink is not None:
                    self.sink.put((channel, party, body, self))
                else:
                    self._q(channel).put((party, body))
        except OSError:
            pass
        self.dead = True

    def _read_exact(self, n: int):
        buf = b""
        while len(buf) < n:
            chunk = self.sock.recv(n - len(buf))
            if not chunk:
                return None
            buf += chunk
        return buf

    def recv(self, channel: int, timeout: float):
        try:
            return self._q(channel).get(timeout=timeout)
        except Empty:
            return None

    def send(self, channel: int, party: int, payload: bytes):
        self.sock.sendall(_HDR.pack(channel, party, len(payload)) + payload)


def _read_frame(sock: socket.socket):
    """Blocking read of one complete frame from `sock` on the CALLING
    thread (bring-up only; steady state reads happen in _Demux).
    Returns (channel, party, payload), or None if the socket timeout
    expires before the first byte (safe to retry/resend); once a frame
    starts arriving it is read to completion (peers write frames
    atomically via sendall)."""
    buf = b""
    started = False
    while len(buf) < _HDR.size:
        try:
            chunk = sock.recv(_HDR.size - len(buf))
        except (TimeoutError, socket.timeout):
            if not started:
                return None
            continue  # mid-frame: the rest is already in flight
        if not chunk:
            raise ConnectionError("peer closed during bring-up")
        buf += chunk
        started = True
    channel, party, length = _HDR.unpack(buf)
    body = b""
    while len(body) < length:
        try:
            chunk = sock.recv(length - len(body))
        except (TimeoutError, socket.timeout):
            continue
        if not chunk:
            raise ConnectionError("peer closed during bring-up")
        body += chunk
    return channel, party, body


def make_self_signed_cert(common_name: str = "zksaas-node"):
    """Self-signed cert + key PEM bytes (gen_cert.rs analog)."""
    import datetime

    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import ec
    from cryptography.x509.oid import NameOID

    key = ec.generate_private_key(ec.SECP256R1())
    name = x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, common_name)])
    now = datetime.datetime.now(datetime.timezone.utc)
    cert = (
        x509.CertificateBuilder()
        .subject_name(name)
        .issuer_name(name)
        .public_key(key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now - datetime.timedelta(minutes=5))
        .not_valid_after(now + datetime.timedelta(days=30))
        .add_extension(
            x509.SubjectAlternativeName([x509.DNSName("localhost")]), critical=False
        )
        .sign(key, hashes.SHA256())
    )
    cert_pem = cert.public_bytes(serialization.Encoding.PEM)
    key_pem = key.private_bytes(
        serialization.Encoding.PEM,
        serialization.PrivateFormat.PKCS8,
        serialization.NoEncryption(),
    )
    return cert_pem, key_pem


def _tls_server_ctx(certfile, keyfile, peer_certs):
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(certfile, keyfile)
    ctx.verify_mode = ssl.CERT_REQUIRED  # mutual TLS, pinned roots
    for c in peer_certs:
        ctx.load_verify_locations(c)
    # No TLS 1.3 session tickets: post-handshake ticket records are
    # processed inside later SSL_read/SSL_write calls, which is exactly
    # the window where the steady-state one-reader/one-writer pattern
    # on a shared SSL object becomes unsafe (observed: lost first
    # frames and an interpreter segfault under load).
    ctx.num_tickets = 0
    return ctx


def _tls_client_ctx(certfile, keyfile, king_cert):
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    ctx.check_hostname = False
    ctx.load_cert_chain(certfile, keyfile)
    ctx.verify_mode = ssl.CERT_REQUIRED
    ctx.load_verify_locations(king_cert)
    return ctx


class StarKing:
    """Party 0.  Binds, accepts n-1 clients, id-exchanges, barriers
    (new_king_tls + new_from_pre_existing_connection, prod.rs:135-243)."""

    def __init__(self, n: int, bind=("127.0.0.1", 0), timeout: float = 30.0, tls_ctx=None):
        self.n = n
        self.timeout = timeout
        srv = socket.create_server(bind)
        self.port = srv.getsockname()[1]
        self._srv = srv
        self._tls = tls_ctx
        self.links: dict[int, _Demux] = {}
        # single inbox shared by every link's demux thread: a gather
        # blocks on one queue (no per-link polling); frames for other
        # channels are stashed until their round asks for them
        self._inbox: Queue = Queue()
        self._stash: dict[int, list] = {}

    def accept_all(self, accept_timeout: float = 120.0):
        """Bring-up is bounded separately from the per-round timeout —
        peers may take long to start (process spawn, TLS handshakes).

        The whole id exchange + SynAck barrier runs SINGLE-THREADED on
        each socket (demux reader threads start only afterwards):
        touching a freshly wrapped SSL socket from two threads — main
        writing the barrier while a reader blocks in SSL_read — is
        undefined in OpenSSL and was observed to lose frames and
        segfault the interpreter under load."""
        self._srv.settimeout(accept_timeout)
        n_links = self.n - 1
        deadline = time.time() + accept_timeout
        pending: dict[int, socket.socket] = {}
        for _ in range(n_links):
            conn, _ = self._srv.accept()
            if self._tls is not None:
                conn = self._tls.wrap_socket(conn, server_side=True)
            # read this link's SYN synchronously (clients retransmit
            # every 2 s until acked, so skip duplicates)
            while True:
                if time.time() >= deadline:
                    raise TimeoutError(
                        f"id exchange: {len(pending)}/{n_links} SYNs within {accept_timeout}s"
                    )
                conn.settimeout(max(0.01, deadline - time.time()))
                got = _read_frame(conn)
                if got is None:
                    continue
                ch, pid, payload = got
                assert ch == _CTRL and payload == _SYN, "bad id-exchange frame"
                if pid not in pending:
                    break
            pending[pid] = conn
        # SynAck barrier: release everyone only once all are connected,
        # then hand each socket to its (single) reader thread
        for pid, conn in pending.items():
            conn.sendall(_HDR.pack(_CTRL, 0, len(_SYNACK)) + _SYNACK)
            conn.settimeout(None)
            self.links[pid] = _Demux(conn, sink=self._inbox)

    def _next_frame(self, channel: int, timeout: float):
        """Pop the next frame for `channel`, consulting the stash first;
        frames for other channels are stashed.  Returns (party, body)
        or None on timeout."""
        buf = self._stash.get(channel)
        if buf:
            return buf.pop(0)
        deadline = time.time() + timeout
        while True:
            remaining = deadline - time.time()
            if remaining <= 0:
                return None
            try:
                ch, party, body, _ = self._inbox.get(timeout=remaining)
            except Empty:
                return None
            if ch == _CTRL:
                continue  # stray retransmitted SYN after the barrier
            if ch == channel:
                return party, body
            self._stash.setdefault(ch, []).append((party, body))

    def gather(self, own: bytes, channel: int, threshold: int) -> ReceivedBytes:
        """client_send_or_king_receive (lib.rs:89-136): collect one
        payload per party with per-round timeout; Partial on dropouts;
        raise below threshold (ser_net.rs:73-81)."""
        shares: list = [None] * self.n
        shares[0] = own
        deadline = time.time() + self.timeout
        expected = self.n - 1
        while expected and time.time() < deadline:
            got = self._next_frame(channel, deadline - time.time())
            if got is None:
                break
            sender, payload = got
            if shares[sender] is None:
                expected -= 1
            shares[sender] = payload
        parties = tuple(i for i in range(self.n) if shares[i] is not None)
        if len(parties) < threshold:
            raise TimeoutError(
                f"only {len(parties)} of {self.n} shares arrived (threshold {threshold})"
            )
        return ReceivedBytes(shares=shares, parties=parties)

    def scatter(self, payloads: list, channel: int):
        """client_receive_or_king_send (lib.rs:139-176): distinct payload
        per party."""
        for pid, demux in self.links.items():
            if payloads[pid] is not None:
                demux.send(channel, 0, payloads[pid])

    def close(self):
        for d in self.links.values():
            try:
                d.sock.close()
            except OSError:
                pass
        self._srv.close()


class StarClient:
    """Parties 1..n-1: one connection to the king (new_peer_tls,
    prod.rs:159-184)."""

    def __init__(
        self,
        party_id: int,
        king_addr,
        timeout: float = 30.0,
        tls_ctx=None,
        retries: int = 50,
        synack_timeout: float = 300.0,
    ):
        self.party_id = party_id
        self.timeout = timeout
        last = None
        for _ in range(retries):
            try:
                sock = socket.create_connection(king_addr, timeout=timeout)
                break
            except OSError as e:  # king not up yet
                last = e
                time.sleep(0.1)
        else:
            raise last
        if tls_ctx is not None:
            sock = tls_ctx.wrap_socket(sock)
        # Bring-up runs single-threaded on this socket (no demux reader
        # yet — see StarKing.accept_all).  Bounded separately from the
        # per-round timeout: the SynAck only arrives after ALL n-1
        # peers connect, which on a loaded box (TLS handshakes, XLA
        # compiles) can take far longer than a protocol round.  The SYN
        # retransmits every 2 s until acked (the king reads this link
        # only after accepting it, so an early SYN can sit unread).
        deadline = time.time() + max(timeout, synack_timeout)
        got = None
        while got is None:
            if time.time() >= deadline:
                raise TimeoutError(f"SynAck barrier failed for party {party_id}")
            sock.sendall(_HDR.pack(_CTRL, party_id, len(_SYN)) + _SYN)
            sock.settimeout(min(2.0, max(0.01, deadline - time.time())))
            got = _read_frame(sock)
        ch, _, payload = got
        if ch != _CTRL or payload != _SYNACK:
            raise TimeoutError(f"SynAck barrier failed for party {party_id}")
        sock.settimeout(None)
        self.link = _Demux(sock)

    def send(self, payload: bytes, channel: int):
        self.link.send(channel, self.party_id, payload)

    def recv(self, channel: int):
        got = self.link.recv(channel, self.timeout)
        if got is None:
            raise TimeoutError(f"no king payload on channel {channel}")
        return got[1]

    def close(self):
        try:
            self.link.sock.close()
        except OSError:
            pass
