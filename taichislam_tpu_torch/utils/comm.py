"""Multi-drone communication backend (TaichiSLAM's distributed layer).

Counterpart of the JAX package's ``utils/comm.py``. Reimplements TaichiSLAM's
SLAMComm (``taichi_slam/utils/communication.py``) —
fire-and-forget UDP-multicast submap/trajectory exchange on channels
``SUBMAP_CHANNEL``/``TRAJ_CHANNEL`` with random 16-bit msg ids and
self-reception suppression — WITHOUT the external lcm library: the transport
speaks the LCM UDPM wire protocol directly (magic ``LC02`` for short
messages, ``LC03`` + fragmentation for large ones), so reference peers using
real LCM on the same multicast group interoperate.

A ``LoopbackTransport`` provides an in-process fake for tests (TaichiSLAM's
multi-node testing relied on real multicast loopback). When the native C++
transport (``taichislam_tpu_torch/runtime``) builds, it serves the socket
hot path; otherwise pure Python sockets serve.
"""

from __future__ import annotations

import random
import socket
import struct
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from taichislam_tpu_torch.utils.lcm_codec import BufferMsg, TimeT

CHANNEL_SUBMAP = "SUBMAP_CHANNEL"
CHANNEL_TRAJ = "TRAJ_CHANNEL"
TIMEOUT_MS = 10

_MAGIC_SHORT = 0x4C433032  # "LC02"
_MAGIC_FRAG = 0x4C433033   # "LC03"
_MAX_DGRAM = 65499         # LCM's maximum datagram payload
_FRAG_SIZE = 60000


def _parse_udpm_url(url: str) -> Tuple[str, int, int]:
    """Parse udpm://ADDR:PORT?ttl=N (communication.py:10 default)."""
    assert url.startswith("udpm://"), url
    rest = url[len("udpm://"):]
    ttl = 0
    if "?" in rest:
        rest, q = rest.split("?", 1)
        for kv in q.split("&"):
            k, _, v = kv.partition("=")
            if k == "ttl":
                ttl = int(v)
    host, _, port = rest.partition(":")
    return host, int(port or 7667), ttl


class UDPMulticastTransport:
    """LCM-UDPM-compatible multicast transport (pure Python sockets)."""

    def __init__(self, url: str = "udpm://224.0.0.251:7667?ttl=1"):
        self.addr, self.port, ttl = _parse_udpm_url(url)
        self.seq = 0
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        # large submaps arrive as bursts of ~60 kB fragments; default rcvbuf
        # drops them (LCM ships the same workaround)
        try:
            self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF,
                                 8 * 1024 * 1024)
        except OSError:
            pass
        try:
            self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
        except (AttributeError, OSError):
            pass
        self.sock.bind(("", self.port))
        mreq = struct.pack("4sl", socket.inet_aton(self.addr),
                           socket.INADDR_ANY)
        self.sock.setsockopt(socket.IPPROTO_IP, socket.IP_ADD_MEMBERSHIP, mreq)
        self.sock.setsockopt(socket.IPPROTO_IP, socket.IP_MULTICAST_TTL, ttl)
        self.sock.setsockopt(socket.IPPROTO_IP, socket.IP_MULTICAST_LOOP, 1)
        self.sock.setblocking(False)
        # (sender, seq) -> [channel, total, nfrag, dict(offset->bytes), t0]
        self._frags: Dict[Tuple, List] = {}

    def publish(self, channel: str, data: bytes):
        chan = channel.encode() + b"\x00"
        self.seq = (self.seq + 1) & 0xFFFFFFFF
        if len(chan) + len(data) + 8 <= _MAX_DGRAM:
            pkt = struct.pack(">II", _MAGIC_SHORT, self.seq) + chan + data
            self.sock.sendto(pkt, (self.addr, self.port))
            return
        nfrag = (len(data) + _FRAG_SIZE - 1) // _FRAG_SIZE
        for fno in range(nfrag):
            off = fno * _FRAG_SIZE
            chunk = data[off:off + _FRAG_SIZE]
            hdr = struct.pack(">IIIIHH", _MAGIC_FRAG, self.seq, len(data),
                              off, fno, nfrag)
            pkt = hdr + (chan if fno == 0 else b"") + chunk
            self.sock.sendto(pkt, (self.addr, self.port))

    def poll(self, timeout_ms: int) -> List[Tuple[str, bytes]]:
        """Drain ready datagrams for up to timeout_ms; returns complete
        (channel, payload) messages."""
        out = []
        deadline = time.time() + timeout_ms / 1000.0
        self.sock.settimeout(max(timeout_ms / 1000.0, 1e-4))
        while True:
            try:
                pkt, sender = self.sock.recvfrom(65536)
            except (socket.timeout, BlockingIOError):
                break
            msg = self._handle_packet(pkt, sender)
            if msg is not None:
                out.append(msg)
            if time.time() >= deadline:
                break
            self.sock.settimeout(max(deadline - time.time(), 1e-4))
        return out

    # partial reassembly state is bounded: entries older than this (lost
    # fragments, or non-first fragments whose header never arrived) are
    # evicted, and the map is capped — real LCM caps its frag buffers too
    _FRAG_TTL_S = 5.0
    _FRAG_MAX_ENTRIES = 64

    def _expire_frags(self, now: float):
        if len(self._frags) > self._FRAG_MAX_ENTRIES:
            for key, _ in sorted(self._frags.items(),
                                 key=lambda kv: kv[1][4])[
                    :len(self._frags) - self._FRAG_MAX_ENTRIES]:
                del self._frags[key]
        dead = [k for k, e in self._frags.items()
                if now - e[4] > self._FRAG_TTL_S]
        for k in dead:
            del self._frags[k]

    def _handle_packet(self, pkt: bytes, sender):
        """Decode one datagram; malformed or hostile packets are dropped
        (the C++ transport does the same) — a bad packet on the open
        multicast group must never crash poll()."""
        if len(pkt) < 8:
            return None
        magic, seq = struct.unpack_from(">II", pkt, 0)
        if magic == _MAGIC_SHORT:
            end = pkt.find(b"\x00", 8)
            if end < 0:
                return None
            try:
                return pkt[8:end].decode(), pkt[end + 1:]
            except UnicodeDecodeError:
                return None
        if magic == _MAGIC_FRAG:
            if len(pkt) < 20:
                return None
            _, seq, total, off, fno, nfrag = struct.unpack_from(">IIIIHH",
                                                                pkt, 0)
            body = pkt[20:]
            now = time.time()
            self._expire_frags(now)
            key = (sender, seq)
            if fno == 0:
                end = body.find(b"\x00")
                if end < 0:
                    return None
                try:
                    chan = body[:end].decode()
                except UnicodeDecodeError:
                    return None
                body = body[end + 1:]
                self._frags[key] = [chan, total, nfrag, {}, now]
            ent = self._frags.get(key)
            if ent is None:
                return None
            ent[3][off] = body
            if len(ent[3]) == ent[2]:
                data = b"".join(ent[3][o] for o in sorted(ent[3]))
                del self._frags[key]
                if len(data) == ent[1]:
                    return ent[0], data
            return None
        return None

    def close(self):
        self.sock.close()


class LoopbackTransport:
    """In-process bus shared by all instances built from the same hub —
    deterministic transport for tests (no real sockets)."""

    class Hub:
        def __init__(self):
            self.queues: List["LoopbackTransport"] = []
            self.lock = threading.Lock()

    def __init__(self, hub: "LoopbackTransport.Hub"):
        self.hub = hub
        self.inbox: List[Tuple[str, bytes]] = []
        with hub.lock:
            hub.queues.append(self)

    def publish(self, channel: str, data: bytes):
        with self.hub.lock:
            for q in self.hub.queues:
                q.inbox.append((channel, bytes(data)))

    def poll(self, timeout_ms: int):
        with self.hub.lock:
            out, self.inbox = self.inbox, []
        return out

    def close(self):
        pass


def make_udpm_transport(url: str = "udpm://224.0.0.251:7667?ttl=1"):
    """Prefer the native C++ transport (taichislam_tpu_torch/runtime, built
    with g++ at first use from the package's ``transport.cpp`` into
    ``build/runtime/`` beside the package); fall back to the pure-Python
    socket implementation when it does not build or load, as the JAX
    package does."""
    try:
        from taichislam_tpu_torch.runtime import (
            NativeUDPMulticastTransport, native_available)
        if native_available():
            return NativeUDPMulticastTransport(url)
    except Exception:
        pass
    return UDPMulticastTransport(url)


class SLAMComm:
    """Drop-in equivalent of the reference SLAMComm
    (communication.py:9-44): publishBuffer / handle / on_submap / on_traj
    callbacks, self-multicast suppression via the sent msg-id set."""

    def __init__(self, drone_id=0, lcm_url="udpm://224.0.0.251:7667?ttl=1",
                 transport=None):
        self.transport = transport or make_udpm_transport(lcm_url)
        self.drone_id = drone_id
        self.sent_msgs = set()
        self.on_submap: Optional[Callable[[bytes], None]] = None
        self.on_traj: Optional[Callable[[bytes], None]] = None

    def publishBuffer(self, buf, channel=CHANNEL_SUBMAP):
        now = time.time()
        msg = BufferMsg(
            timestamp=TimeT(int(now), int((now % 1) * 1e9)),
            drone_id=self.drone_id,
            msg_id=random.randint(0, 2 ** 16),
            buffer=bytes(buf))
        self.sent_msgs.add(msg.msg_id)
        self.transport.publish(channel, msg.encode())

    def handle_submap(self, channel, data):
        msg = BufferMsg.decode(data)
        if msg.msg_id in self.sent_msgs:
            return
        if self.on_submap is not None:
            self.on_submap(msg.buffer)

    def handle_traj(self, channel, data):
        msg = BufferMsg.decode(data)
        if msg.msg_id in self.sent_msgs:
            return
        self.sent_msgs.add(msg.msg_id)
        if self.on_traj is not None:
            self.on_traj(msg.buffer)

    def handle(self):
        for channel, data in self.transport.poll(TIMEOUT_MS):
            try:
                if channel == CHANNEL_SUBMAP:
                    self.handle_submap(channel, data)
                elif channel == CHANNEL_TRAJ:
                    self.handle_traj(channel, data)
            except Exception as e:
                # hostile/corrupt payloads on the open multicast group are
                # dropped, never crash the node main loop. The decode path
                # raises more than (ValueError, struct.error): zlib.error on
                # corrupt streams, zipfile.BadZipFile on malformed npz,
                # KeyError on an npz missing expected keys — catch them all
                # at this boundary (the callbacks are the last line before
                # untrusted bytes reach the node loop).
                print(f"[SLAMComm] dropped malformed msg on {channel}: "
                      f"{type(e).__name__}: {e}")

    def close(self):
        self.transport.close()
