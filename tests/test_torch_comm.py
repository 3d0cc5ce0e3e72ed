"""The port's comm layer (utils/lcm_codec.py, utils/comm.py, runtime/):
twins of tests/test_comm.py, plus checks across the two packages.

Drones running either package share one multicast group, so the LCM
``Buffer`` bytes must be the same both ways, and a JAX ``SLAMComm`` and a
port ``SLAMComm`` on one loopback hub exchange submaps in both directions.
The port's native transport builds with g++ into ``build/runtime/`` (never
into the package).
"""

import time
import zlib

import numpy as np
import pytest

from taichislam_tpu.utils import comm as jcomm
from taichislam_tpu.utils import lcm_codec as jcodec
from taichislam_tpu_torch import runtime as truntime
from taichislam_tpu_torch.utils import comm as tcomm
from taichislam_tpu_torch.utils import lcm_codec as tcodec


def test_buffer_codec_roundtrip():
    msg = tcodec.BufferMsg(tcodec.TimeT(12, 34), drone_id=3, msg_id=777,
                           buffer=b"hello world")
    data = msg.encode()
    assert data[:8] == tcodec.BUFFER_FINGERPRINT
    back = tcodec.BufferMsg.decode(data)
    assert back.drone_id == 3
    assert back.msg_id == 777
    assert back.buffer == b"hello world"
    assert back.timestamp.sec == 12 and back.timestamp.nsec == 34


def test_buffer_fingerprint_matches_lcm_gen():
    assert tcodec.BUFFER_FINGERPRINT.hex() == "c0b52b72031a4c9f"
    assert tcodec.BUFFER_FINGERPRINT == jcodec.BUFFER_FINGERPRINT
    assert tcodec.TIME_T_FINGERPRINT == jcodec.TIME_T_FINGERPRINT


@pytest.mark.parametrize("src,dst", [(tcodec, jcodec), (jcodec, tcodec)],
                         ids=["port_to_jax", "jax_to_port"])
def test_buffer_bytes_cross_packages(src, dst):
    """Each package's encoding decodes in the other, and both encode the
    same message to the same bytes."""
    rng = np.random.default_rng(4)
    payload = bytes(rng.integers(0, 256, 5000, dtype=np.uint8))
    kw = dict(drone_id=7, msg_id=65535, buffer=payload)
    a = src.BufferMsg(src.TimeT(1700000000, 123456789), **kw).encode()
    b = dst.BufferMsg(dst.TimeT(1700000000, 123456789), **kw).encode()
    assert a == b
    back = dst.BufferMsg.decode(a)
    assert (back.drone_id, back.msg_id, back.buffer) == (7, 65535, payload)
    assert (back.timestamp.sec, back.timestamp.nsec) == (1700000000,
                                                         123456789)
    with pytest.raises(ValueError):
        dst.BufferMsg.decode(b"\x00" * 8 + a[8:])


def test_loopback_two_drones_submap_exchange():
    hub = tcomm.LoopbackTransport.Hub()
    a = tcomm.SLAMComm(drone_id=0, transport=tcomm.LoopbackTransport(hub))
    b = tcomm.SLAMComm(drone_id=1, transport=tcomm.LoopbackTransport(hub))
    got_a, got_b = [], []
    a.on_submap = got_a.append
    b.on_submap = got_b.append

    payload = zlib.compress(b"x" * 100000, 1)
    a.publishBuffer(payload, tcomm.CHANNEL_SUBMAP)
    a.handle()
    b.handle()
    # sender suppresses its own message; receiver gets it
    assert got_a == []
    assert got_b == [payload]


def test_loopback_traj_channel():
    hub = tcomm.LoopbackTransport.Hub()
    a = tcomm.SLAMComm(drone_id=0, transport=tcomm.LoopbackTransport(hub))
    b = tcomm.SLAMComm(drone_id=1, transport=tcomm.LoopbackTransport(hub))
    got = []
    b.on_traj = got.append
    a.publishBuffer(b"traj-bytes", tcomm.CHANNEL_TRAJ)
    b.handle()
    assert got == [b"traj-bytes"]


def test_jax_and_port_comms_share_a_hub():
    """A JAX SLAMComm and a port SLAMComm on one hub (the JAX package's
    LoopbackTransport, injected into the port's comm): a submap and a
    trajectory go both ways, a malformed payload is dropped, and neither
    side hears itself."""
    hub = jcomm.LoopbackTransport.Hub()
    j = jcomm.SLAMComm(drone_id=0, transport=jcomm.LoopbackTransport(hub))
    t = tcomm.SLAMComm(drone_id=1, transport=jcomm.LoopbackTransport(hub))
    got = {"j": [], "t": [], "jt": [], "tt": []}
    j.on_submap, t.on_submap = got["j"].append, got["t"].append
    j.on_traj, t.on_traj = got["jt"].append, got["tt"].append
    sub_j = zlib.compress(b"jax submap" * 5000, 1)
    sub_t = zlib.compress(b"port submap" * 5000, 1)
    j.publishBuffer(sub_j, jcomm.CHANNEL_SUBMAP)
    t.publishBuffer(sub_t, tcomm.CHANNEL_SUBMAP)
    t.publishBuffer(b"port traj", tcomm.CHANNEL_TRAJ)
    j.transport.publish(tcomm.CHANNEL_SUBMAP, b"not an lcm buffer")
    j.handle()
    t.handle()
    assert got == {"j": [sub_t], "t": [sub_j], "jt": [b"port traj"],
                   "tt": []}


def test_udpm_url_parse_matches_jax():
    for url in ("udpm://224.0.0.251:7667?ttl=1", "udpm://239.255.76.67",
                "udpm://224.0.0.251:17998?ttl=0&recv_buf_size=1"):
        assert tcomm._parse_udpm_url(url) == jcomm._parse_udpm_url(url)


def test_native_transport_builds_outside_the_package():
    """The native transport builds from the port's transport.cpp (a copy
    of the JAX package's) into build/runtime/, never into the package."""
    from pathlib import Path
    import taichislam_tpu_torch
    pkg = Path(taichislam_tpu_torch.__file__).resolve().parent
    jsrc = pkg.parent / "taichislam_tpu" / "runtime" / "transport.cpp"

    def code(path):   # the source past its leading comment block
        lines = path.read_text().splitlines()
        return lines[next(i for i, ln in enumerate(lines)
                          if ln and not ln.startswith("//")):]
    assert code(truntime.SRC) == code(jsrc)
    path = truntime.library_path()
    assert pkg not in path.parents and path.parent.name == "runtime" and \
        path.parent.parent.name == "build"
    if not truntime.native_available():
        pytest.skip("g++ could not build the native transport here")
    assert path.exists()
    assert not list(pkg.rglob("*.so"))


def test_native_transport_interop_with_python():
    """C++ transport (taichislam_tpu_torch/runtime) <-> Python transport
    over real multicast loopback, both directions, incl. fragmentation."""
    if not truntime.native_available():
        pytest.skip("native transport not built")
    url = "udpm://224.0.0.251:17999?ttl=0"
    try:
        nat = truntime.NativeUDPMulticastTransport(url)
        py = tcomm.UDPMulticastTransport(url)
    except OSError:
        pytest.skip("multicast unavailable on this host")
    try:
        time.sleep(0.2)
        nat.publish("chan", b"hello-from-native")
        msgs = py.poll(500)
        if not msgs:
            pytest.skip("multicast loopback not delivered on this host")
        assert ("chan", b"hello-from-native") in msgs

        big = bytes(np.random.default_rng(0).integers(
            0, 256, 250000, dtype=np.uint8))
        py.publish("big", big)
        got = {}
        for _ in range(10):
            for c, d in nat.poll(300):
                got[c] = d
            if "big" in got:
                break
        assert got.get("big") == big
    finally:
        nat.close()
        py.close()


def test_udpm_transport_loopback_short_and_fragmented():
    try:
        t1 = tcomm.UDPMulticastTransport("udpm://224.0.0.251:17668?ttl=0")
        t2 = tcomm.UDPMulticastTransport("udpm://224.0.0.251:17668?ttl=0")
    except OSError:
        pytest.skip("multicast unavailable on this host")
    try:
        t1.publish("chan", b"small")
        msgs = t2.poll(300)
        if not msgs:
            pytest.skip("multicast loopback not delivered on this host")
        assert ("chan", b"small") in msgs

        big = bytes(np.random.default_rng(0).integers(
            0, 256, 300000, dtype=np.uint8))
        t1.publish("big", big)
        got = {}
        for _ in range(10):
            for c, d in t2.poll(200):
                got[c] = d
            if "big" in got:
                break
        assert got.get("big") == big
    finally:
        t1.close()
        t2.close()


def test_make_udpm_transport_prefers_native():
    """make_udpm_transport returns the port's native transport when it
    builds and binds, else the pure-Python one, and the port's classes
    only."""
    try:
        tr = tcomm.make_udpm_transport("udpm://224.0.0.251:17669?ttl=0")
    except OSError:
        pytest.skip("multicast unavailable on this host")
    try:
        want = (truntime.NativeUDPMulticastTransport
                if truntime.native_available()
                else tcomm.UDPMulticastTransport)
        assert type(tr) is want
    finally:
        tr.close()
