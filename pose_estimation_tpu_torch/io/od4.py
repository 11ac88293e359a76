"""Live OD4 (libcluon UDP-multicast) ingestion adapter.

The reference's only asynchronous entry is a cluon::OD4Session feeding IMU
callbacks into `VisualInertialSLAM::collectImuData`
(`src/cfsd-state-estimation.cpp:50-95`). This module is the
wire-compatible Python replacement: a UDP listener decoding cluon envelopes
(`0x0D 0xA4 LEN0 LEN1 LEN2 <proto(cluon::data::Envelope)>`, little-endian
length — `cluon-complete-v0.0.121.hpp:7926-7935`) and dispatching
data-triggered callbacks, plus the matching encoder so tests/tools can
synthesize sessions without libcluon.

cluon's proto conventions (`ToProtoVisitor::encode`, `:10940-10993`):
int32 -> zigzag varint, uint32 -> varint, float -> 4-byte LE (wiretype 5),
bytes/nested -> length-delimited (wiretype 2).

Envelope fields (`cluon-complete hpp:4592-4617`):
    1: dataType (int32)        4: received (TimeStamp)
    2: serializedData (bytes)  5: sampleTimeStamp (TimeStamp)
    3: sent (TimeStamp)        6: senderStamp (uint32)
TimeStamp: 1 = seconds (int32), 2 = microseconds (int32).

Message set (`opendlv-standard-message-set-v0.9.7.odvd:71-81`):
    opendlv.proxy.AccelerationReading    [id 1030] floats x, y, z
    opendlv.proxy.AngularVelocityReading [id 1031] floats x, y, z

A copy of `pose_estimation_tpu/io/od4.py` whose `attach_imu` feeds the
port's `slam.VisualInertialSLAM`; `tests/test_torch_io.py` holds the copy
equal to the original.
"""

from __future__ import annotations

import socket
import struct
import threading
from typing import Callable, NamedTuple

ACCELERATION_READING = 1030
ANGULAR_VELOCITY_READING = 1031
OD4_PORT = 12175


# --------------------------------------------------------------------------- #
# proto primitives (cluon flavor)
# --------------------------------------------------------------------------- #

def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    out = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, pos
        shift += 7


def _zigzag32(v: int) -> int:
    return ((v << 1) ^ (v >> 31)) & 0xFFFFFFFF


def _unzigzag(v: int) -> int:
    return (v >> 1) ^ -(v & 1)


def _key(field_id: int, wire: int) -> bytes:
    return _varint((field_id << 3) | wire)


def _f_int32(field_id: int, v: int) -> bytes:
    return _key(field_id, 0) + _varint(_zigzag32(v))


def _f_uint32(field_id: int, v: int) -> bytes:
    return _key(field_id, 0) + _varint(v)


def _f_bytes(field_id: int, v: bytes) -> bytes:
    return _key(field_id, 2) + _varint(len(v)) + v


def _f_float(field_id: int, v: float) -> bytes:
    return _key(field_id, 5) + struct.pack("<f", v)


def _timestamp(field_id: int, seconds: int, micros: int) -> bytes:
    return _f_bytes(field_id, _f_int32(1, seconds) + _f_int32(2, micros))


def _parse_fields(buf: bytes):
    """Yield (field_id, wire, value) — value is int (wiretype 0), bytes (2),
    or raw 4/8 bytes (5/1)."""
    pos = 0
    n = len(buf)
    while pos < n:
        k, pos = _read_varint(buf, pos)
        fid, wire = k >> 3, k & 7
        if wire == 0:
            v, pos = _read_varint(buf, pos)
        elif wire == 2:
            ln, pos = _read_varint(buf, pos)
            v = buf[pos : pos + ln]
            pos += ln
        elif wire == 5:
            v = buf[pos : pos + 4]
            pos += 4
        elif wire == 1:
            v = buf[pos : pos + 8]
            pos += 8
        else:  # unknown wire type: cannot continue safely
            return
        yield fid, wire, v


# --------------------------------------------------------------------------- #
# envelopes + readings
# --------------------------------------------------------------------------- #

class Envelope(NamedTuple):
    data_type: int
    serialized_data: bytes
    sample_seconds: int
    sample_micros: int
    sender_stamp: int

    @property
    def sample_ns(self) -> int:
        return self.sample_seconds * 1_000_000_000 + self.sample_micros * 1_000


def encode_reading(x: float, y: float, z: float) -> bytes:
    """AccelerationReading / AngularVelocityReading payload (floats 1..3)."""
    return _f_float(1, x) + _f_float(2, y) + _f_float(3, z)


def decode_reading(buf: bytes) -> tuple[float, float, float]:
    vals = {1: 0.0, 2: 0.0, 3: 0.0}
    for fid, wire, v in _parse_fields(buf):
        if wire == 5 and fid in vals:
            vals[fid] = struct.unpack("<f", v)[0]
    return vals[1], vals[2], vals[3]


def encode_envelope(env: Envelope) -> bytes:
    """OD4 datagram: 0x0D 0xA4 LEN(3, LE) + proto(Envelope)."""
    body = (
        _f_int32(1, env.data_type)
        + _f_bytes(2, env.serialized_data)
        + _timestamp(5, env.sample_seconds, env.sample_micros)
        + _f_uint32(6, env.sender_stamp)
    )
    n = len(body)
    return bytes([0x0D, 0xA4, n & 0xFF, (n >> 8) & 0xFF, (n >> 16) & 0xFF]) + body


def decode_envelope(datagram: bytes) -> Envelope | None:
    if len(datagram) < 5 or datagram[0] != 0x0D or datagram[1] != 0xA4:
        return None
    n = datagram[2] | (datagram[3] << 8) | (datagram[4] << 16)
    body = datagram[5 : 5 + n]
    if len(body) < n:
        return None
    data_type = 0
    payload = b""
    sec = us = 0
    sender = 0
    for fid, wire, v in _parse_fields(body):
        if fid == 1 and wire == 0:
            data_type = _unzigzag(v)
        elif fid == 2 and wire == 2:
            payload = v
        elif fid == 5 and wire == 2:
            for tfid, twire, tv in _parse_fields(v):
                if twire == 0 and tfid == 1:
                    sec = _unzigzag(tv)
                elif twire == 0 and tfid == 2:
                    us = _unzigzag(tv)
        elif fid == 6 and wire == 0:
            sender = v
    return Envelope(data_type, payload, sec, us, sender)


# --------------------------------------------------------------------------- #
# session
# --------------------------------------------------------------------------- #

class OD4Session:
    """UDP listener speaking the OD4 wire format.

    Binds 0.0.0.0:12175 and (best-effort) joins the 225.0.0.<cid> multicast
    group, so it receives both real OD4 multicast traffic and plain unicast
    datagrams (used by tests and replay tools). Callbacks registered with
    `data_trigger` run on the receive thread — exactly the reference's
    threading model (`cfsd-state-estimation.cpp:94-95`), where
    `collect_imu_data`'s queue is the synchronization point.
    """

    def __init__(self, cid: int, port: int = OD4_PORT):
        self.cid = cid
        self._triggers: dict[int, Callable[[Envelope], None]] = {}
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind(("", port))
        self._group = f"225.0.0.{cid}"
        try:
            mreq = struct.pack(
                "4s4s", socket.inet_aton(self._group),
                socket.inet_aton("0.0.0.0"),
            )
            self._sock.setsockopt(
                socket.IPPROTO_IP, socket.IP_ADD_MEMBERSHIP, mreq
            )
        except OSError:
            pass  # no multicast route (an isolated network); unicast still works
        self._sock.settimeout(0.2)
        self._running = True
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def data_trigger(self, message_id: int, fn: Callable[[Envelope], None]):
        self._triggers[message_id] = fn

    def send(self, env: Envelope, addr: str | None = None, port: int = OD4_PORT):
        out = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            out.setsockopt(socket.IPPROTO_IP, socket.IP_MULTICAST_TTL, 1)
            out.sendto(encode_envelope(env), (addr or self._group, port))
        finally:
            out.close()

    def is_running(self) -> bool:
        return self._running

    def stop(self):
        self._running = False
        self._thread.join(timeout=2.0)
        self._sock.close()

    def _loop(self):
        while self._running:
            try:
                datagram, _ = self._sock.recvfrom(65536)
            except socket.timeout:
                continue
            except OSError:
                return
            env = decode_envelope(datagram)
            if env is None:
                continue
            fn = self._triggers.get(env.data_type)
            if fn is not None:
                fn(env)


def attach_imu(od4: OD4Session, slam, ellipse_id: int | None = None):
    """Wire IMU readings into `collect_imu_data` exactly like the reference
    entry (`cfsd-state-estimation.cpp:50-95`): AngularVelocityReading ->
    GYROSCOPE, AccelerationReading -> ACCELEROMETER, optionally filtered by
    the sender stamp (the car's `ellipseID`)."""
    from pose_estimation_tpu_torch.slam import SensorType

    def on_gyr(env: Envelope):
        if ellipse_id is not None and env.sender_stamp != ellipse_id:
            return
        x, y, z = decode_reading(env.serialized_data)
        slam.collect_imu_data(SensorType.GYROSCOPE, env.sample_ns, x, y, z)

    def on_acc(env: Envelope):
        if ellipse_id is not None and env.sender_stamp != ellipse_id:
            return
        x, y, z = decode_reading(env.serialized_data)
        slam.collect_imu_data(SensorType.ACCELEROMETER, env.sample_ns, x, y, z)

    od4.data_trigger(ANGULAR_VELOCITY_READING, on_gyr)
    od4.data_trigger(ACCELERATION_READING, on_acc)
