"""Wire-compatible codecs for TaichiSLAM's LCM message types.

Counterpart of the JAX package's ``utils/lcm_codec.py``, byte for byte:
drones running either package share one multicast group. TaichiSLAM
exchanges submaps/trajectories as lcm-gen'd ``Buffer`` messages
(``taichi_slam/utils/Buffer.py``, ``Time_t.py``): a Time_t header (sec, nsec
as big-endian i32) + (drone_id, msg_id, msg_len as big-endian i32) + raw
bytes, prefixed by the 8-byte LCM type fingerprint. The fingerprint
constants are the LCM schema hashes (data, not code) and must match
bit-for-bit for interop with TaichiSLAM peers.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

_MASK = 0xFFFFFFFFFFFFFFFF


def _rot1(h: int) -> int:
    h &= _MASK
    return (((h << 1) & _MASK) + (h >> 63)) & _MASK


# LCM schema base hashes (from the lcm-gen'd types; Buffer.py:61, Time_t.py:50)
_TIME_T_BASE = 0xDE1D24A3A8ECB648
_BUFFER_BASE = 0x24204C71AFB3B9BE

TIME_T_FINGERPRINT = struct.pack(">Q", _rot1(_TIME_T_BASE))
BUFFER_FINGERPRINT = struct.pack(
    ">Q", _rot1((_BUFFER_BASE + _rot1(_TIME_T_BASE)) & _MASK))


@dataclass
class TimeT:
    sec: int = 0
    nsec: int = 0

    def encode_into(self) -> bytes:
        return struct.pack(">ii", self.sec, self.nsec)

    @staticmethod
    def decode_from(data: bytes, off: int):
        sec, nsec = struct.unpack_from(">ii", data, off)
        return TimeT(sec, nsec), off + 8


@dataclass
class BufferMsg:
    timestamp: TimeT = field(default_factory=TimeT)
    drone_id: int = 0
    msg_id: int = 0
    buffer: bytes = b""

    def encode(self) -> bytes:
        return (BUFFER_FINGERPRINT + self.timestamp.encode_into() +
                struct.pack(">iii", self.drone_id, self.msg_id,
                            len(self.buffer)) + bytes(self.buffer))

    @staticmethod
    def decode(data: bytes) -> "BufferMsg":
        if data[:8] != BUFFER_FINGERPRINT:
            raise ValueError("Decode error")
        ts, off = TimeT.decode_from(data, 8)
        drone_id, msg_id, msg_len = struct.unpack_from(">iii", data, off)
        off += 12
        return BufferMsg(ts, drone_id, msg_id, data[off:off + msg_len])
