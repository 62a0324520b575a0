"""SSH 2.0 transport (RFC 4253/4252/4254) — the carrier for the SFTP
file system (datasource/file/sftp.py).

Reference parity: pkg/gofr/datasource/file/sftp (535 LoC over
github.com/pkg/sftp + golang.org/x/crypto/ssh). This image has no SSH
library, so the transport is implemented from the RFCs on the
``cryptography`` primitives:

- key exchange **curve25519-sha256** (RFC 8731), host keys
  **ssh-ed25519** (RFC 8709), cipher **aes128-ctr** (RFC 4344), MAC
  **hmac-sha2-256** (RFC 6668) — a modern-default algorithm suite;
- binary packet protocol with per-direction sequence numbers, encrypted
  length fields, HMAC over ``seq || plaintext``;
- password userauth (RFC 4252 §8);
- one "session" channel running the "sftp" subsystem with real window
  flow control (RFC 4254 §5.2).

Both the client (SFTP driver) and the test server
(testutil/sftp_server.py) build on this class; the handshake is the
actual wire interop — keys are derived independently on each side from
the exchange hash, so a framing or derivation bug fails loudly.

The port's copy of ``gofr_tpu/datasource/file/ssh_transport.py``; it imports nothing of the JAX package.
"""

from __future__ import annotations

import hashlib
import hmac as hmac_mod
import os
import socket
import struct
import threading
from typing import Any, Callable

try:
    from cryptography.hazmat.primitives.asymmetric.ed25519 import (
        Ed25519PrivateKey,
        Ed25519PublicKey,
    )
    from cryptography.hazmat.primitives.asymmetric.x25519 import (
        X25519PrivateKey,
        X25519PublicKey,
    )
    from cryptography.hazmat.primitives.ciphers import Cipher, algorithms, modes

    _HAS_CRYPTO = True
except ImportError:  # wire primitives (RFC 4251 types, banner) stay usable
    Ed25519PrivateKey = Ed25519PublicKey = None  # type: ignore[assignment]
    X25519PrivateKey = X25519PublicKey = None  # type: ignore[assignment]
    Cipher = algorithms = modes = None  # type: ignore[assignment]
    _HAS_CRYPTO = False

VERSION_STRING = "SSH-2.0-gofrtpu_0.1"

# message numbers (RFC 4253 §12, 4252, 4254)
MSG_DISCONNECT = 1
MSG_IGNORE = 2
MSG_UNIMPLEMENTED = 3
MSG_DEBUG = 4
MSG_SERVICE_REQUEST = 5
MSG_SERVICE_ACCEPT = 6
MSG_KEXINIT = 20
MSG_NEWKEYS = 21
MSG_KEX_ECDH_INIT = 30
MSG_KEX_ECDH_REPLY = 31
MSG_USERAUTH_REQUEST = 50
MSG_USERAUTH_FAILURE = 51
MSG_USERAUTH_SUCCESS = 52
MSG_USERAUTH_BANNER = 53
MSG_GLOBAL_REQUEST = 80
MSG_REQUEST_SUCCESS = 81
MSG_REQUEST_FAILURE = 82
MSG_CHANNEL_OPEN = 90
MSG_CHANNEL_OPEN_CONFIRMATION = 91
MSG_CHANNEL_OPEN_FAILURE = 92
MSG_CHANNEL_WINDOW_ADJUST = 93
MSG_CHANNEL_DATA = 94
MSG_CHANNEL_EOF = 96
MSG_CHANNEL_CLOSE = 97
MSG_CHANNEL_REQUEST = 98
MSG_CHANNEL_SUCCESS = 99
MSG_CHANNEL_FAILURE = 100

KEX_ALGO = b"curve25519-sha256"
HOSTKEY_ALGO = b"ssh-ed25519"
CIPHER_ALGO = b"aes128-ctr"
MAC_ALGO = b"hmac-sha2-256"
COMPRESSION = b"none"

WINDOW_SIZE = 1 << 21
MAX_PACKET = 32768


class SSHError(ConnectionError):
    pass


class SSHAuthError(SSHError):
    pass


# ---------------------------------------------------------------- codec
def u32(v: int) -> bytes:
    return struct.pack(">I", v)


def sstr(b: bytes) -> bytes:
    return u32(len(b)) + b


def mpint(v: bytes) -> bytes:
    """Positive multiple-precision integer from unsigned big-endian bytes."""
    v = v.lstrip(b"\x00")
    if v and v[0] & 0x80:
        v = b"\x00" + v
    return sstr(v)


def name_list(*names: bytes) -> bytes:
    return sstr(b",".join(names))


class Reader:
    def __init__(self, data: bytes) -> None:
        self.data = data
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise SSHError("short read in SSH message")
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def byte(self) -> int:
        return self.take(1)[0]

    def boolean(self) -> bool:
        return self.byte() != 0

    def uint32(self) -> int:
        return struct.unpack(">I", self.take(4))[0]

    def uint64(self) -> int:
        return struct.unpack(">Q", self.take(8))[0]

    def string(self) -> bytes:
        return self.take(self.uint32())

    def remaining(self) -> int:
        return len(self.data) - self.pos


def ed25519_blob(pub: Ed25519PublicKey) -> bytes:
    from cryptography.hazmat.primitives.serialization import (
        Encoding,
        PublicFormat,
    )

    raw = pub.public_bytes(Encoding.Raw, PublicFormat.Raw)
    return sstr(HOSTKEY_ALGO) + sstr(raw)


# ---------------------------------------------------------------- transport
class SSHTransport:
    """One SSH connection (client or server role). After ``handshake()``
    (+ auth + channel setup), ``send_channel_data``/``recv_channel_data``
    move subsystem bytes with window flow control."""

    def __init__(self, sock: socket.socket, server_side: bool = False,
                 host_key: Ed25519PrivateKey | None = None) -> None:
        if not _HAS_CRYPTO:
            raise RuntimeError(
                "SSH transport needs the cryptography package "
                "(curve25519/ed25519/AES primitives)"
            )
        self.sock = sock
        self.server_side = server_side
        self.host_key = host_key  # server role
        self.session_id: bytes | None = None
        self.server_host_key_blob: bytes | None = None  # client role, post-kex
        self._send_seq = 0
        self._recv_seq = 0
        self._encryptor: Any = None
        self._decryptor: Any = None
        self._mac_out: bytes | None = None
        self._mac_in: bytes | None = None
        self._send_lock = threading.Lock()
        # channel state (single session channel, single-threaded use — the
        # SFTP protocol is strict request/response so no cross-thread
        # coordination is needed)
        self.local_channel = 0
        self.remote_channel = 0
        self._recv_window = WINDOW_SIZE  # what we granted the peer
        self._send_window = 0  # what the peer granted us
        self._remote_max_packet = MAX_PACKET  # peer's advertised cap (RFC 4254 §5.2)
        self._inbox: list[bytes] = []  # decrypted CHANNEL_DATA payloads
        self._eof = False

    # -- version exchange + binary packets ---------------------------------
    def _exchange_versions(self) -> tuple[bytes, bytes]:
        self.sock.sendall(VERSION_STRING.encode() + b"\r\n")
        buf = b""
        while True:
            ch = self.sock.recv(1)
            if not ch:
                raise SSHError("peer closed during version exchange")
            buf += ch
            if buf.endswith(b"\n"):
                line = buf.strip()
                if line.startswith(b"SSH-"):
                    if not line.startswith(b"SSH-2.0-"):
                        raise SSHError(f"unsupported SSH version {line!r}")
                    remote = line
                    break
                buf = b""  # pre-version banner lines are allowed
            if len(buf) > 4096:
                raise SSHError("oversized version line")
        local = VERSION_STRING.encode()
        return (local, remote) if not self.server_side else (remote, local)

    def _recv_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self.sock.recv(n - len(buf))
            if not chunk:
                raise SSHError("connection closed by peer")
            buf += chunk
        return buf

    def send_packet(self, payload: bytes) -> None:
        with self._send_lock:
            block = 16 if self._encryptor is not None else 8
            # 4 (len) + 1 (padlen) + payload + padding ≡ 0 mod block
            padlen = block - ((5 + len(payload)) % block)
            if padlen < 4:
                padlen += block
            packet = (
                u32(1 + len(payload) + padlen)
                + bytes([padlen])
                + payload
                + os.urandom(padlen)
            )
            if self._encryptor is not None:
                mac = hmac_mod.new(
                    self._mac_out, u32(self._send_seq) + packet, hashlib.sha256
                ).digest()
                packet = self._encryptor.update(packet) + mac
            # gofrlint: disable=hold-and-block -- _send_lock pairs the
            # packet bytes with their MAC sequence number; an interleaved
            # send would desync the SSH transport MAC stream
            self.sock.sendall(packet)
            self._send_seq = (self._send_seq + 1) & 0xFFFFFFFF

    def recv_packet(self) -> bytes:
        if self._decryptor is not None:
            first = self._decryptor.update(self._recv_exact(16))
            (length,) = struct.unpack(">I", first[:4])
            if length < 1 or length > 1 << 20:
                raise SSHError(f"bad packet length {length}")
            rest = self._decryptor.update(self._recv_exact(length + 4 - 16))
            packet = first + rest
            mac = self._recv_exact(32)
            want = hmac_mod.new(
                self._mac_in, u32(self._recv_seq) + packet, hashlib.sha256
            ).digest()
            if not hmac_mod.compare_digest(mac, want):
                raise SSHError("MAC verification failed")
        else:
            first = self._recv_exact(4)
            (length,) = struct.unpack(">I", first)
            if length < 1 or length > 1 << 20:
                raise SSHError(f"bad packet length {length}")
            packet = first + self._recv_exact(length)
        self._recv_seq = (self._recv_seq + 1) & 0xFFFFFFFF
        padlen = packet[4]
        # body = padlen byte + payload + padding; payload ends at
        # 4 (len field) + 1 (padlen byte) + (length - padlen - 1)
        (length,) = struct.unpack(">I", packet[:4])
        return packet[5 : 4 + length - padlen]

    # -- key exchange ------------------------------------------------------
    def _kexinit_payload(self) -> bytes:
        return (
            bytes([MSG_KEXINIT])
            + os.urandom(16)
            + name_list(KEX_ALGO)
            + name_list(HOSTKEY_ALGO)
            + name_list(CIPHER_ALGO) * 2  # c2s, s2c
            + name_list(MAC_ALGO) * 2
            + name_list(COMPRESSION) * 2
            + name_list() * 2  # languages
            + b"\x00"  # first_kex_packet_follows
            + u32(0)
        )

    @staticmethod
    def _check_kexinit(payload: bytes) -> None:
        r = Reader(payload)
        if r.byte() != MSG_KEXINIT:
            raise SSHError("expected KEXINIT")
        r.take(16)
        lists = [r.string() for _ in range(10)]
        for i, want in ((0, KEX_ALGO), (1, HOSTKEY_ALGO), (2, CIPHER_ALGO),
                        (3, CIPHER_ALGO), (4, MAC_ALGO), (5, MAC_ALGO)):
            if want not in lists[i].split(b","):
                raise SSHError(
                    f"algorithm negotiation failed: {want!r} not offered"
                )

    def _derive(self, k_mpint: bytes, h: bytes, tag: bytes, size: int) -> bytes:
        out = hashlib.sha256(k_mpint + h + tag + self.session_id).digest()
        while len(out) < size:
            out += hashlib.sha256(k_mpint + h + out).digest()
        return out[:size]

    def _activate_keys(self, k_mpint: bytes, h: bytes) -> None:
        if self.session_id is None:
            self.session_id = h
        iv_c2s = self._derive(k_mpint, h, b"A", 16)
        iv_s2c = self._derive(k_mpint, h, b"B", 16)
        key_c2s = self._derive(k_mpint, h, b"C", 16)
        key_s2c = self._derive(k_mpint, h, b"D", 16)
        mac_c2s = self._derive(k_mpint, h, b"E", 32)
        mac_s2c = self._derive(k_mpint, h, b"F", 32)
        c2s = Cipher(algorithms.AES(key_c2s), modes.CTR(iv_c2s))
        s2c = Cipher(algorithms.AES(key_s2c), modes.CTR(iv_s2c))
        if self.server_side:
            self._decryptor = c2s.decryptor()
            self._encryptor = s2c.encryptor()
            self._mac_in, self._mac_out = mac_c2s, mac_s2c
        else:
            self._encryptor = c2s.encryptor()
            self._decryptor = s2c.decryptor()
            self._mac_in, self._mac_out = mac_s2c, mac_c2s

    def handshake(self) -> None:
        v_c, v_s = self._exchange_versions()
        local_kexinit = self._kexinit_payload()
        self.send_packet(local_kexinit)
        remote_kexinit = self.recv_packet()
        self._check_kexinit(remote_kexinit)
        i_c = local_kexinit if not self.server_side else remote_kexinit
        i_s = remote_kexinit if not self.server_side else local_kexinit

        if self.server_side:
            self._kex_server(v_c, v_s, i_c, i_s)
        else:
            self._kex_client(v_c, v_s, i_c, i_s)

        # NEWKEYS swap
        self.send_packet(bytes([MSG_NEWKEYS]))
        payload = self.recv_packet()
        if payload[0] != MSG_NEWKEYS:
            raise SSHError("expected NEWKEYS")

    def _exchange_hash(self, v_c: bytes, v_s: bytes, i_c: bytes, i_s: bytes,
                       k_s: bytes, q_c: bytes, q_s: bytes, k_mpint: bytes) -> bytes:
        return hashlib.sha256(
            sstr(v_c) + sstr(v_s) + sstr(i_c) + sstr(i_s)
            + sstr(k_s) + sstr(q_c) + sstr(q_s) + k_mpint
        ).digest()

    def _kex_client(self, v_c: bytes, v_s: bytes, i_c: bytes, i_s: bytes) -> None:
        from cryptography.hazmat.primitives.serialization import (
            Encoding,
            PublicFormat,
        )

        eph = X25519PrivateKey.generate()
        q_c = eph.public_key().public_bytes(Encoding.Raw, PublicFormat.Raw)
        self.send_packet(bytes([MSG_KEX_ECDH_INIT]) + sstr(q_c))
        r = Reader(self.recv_packet())
        if r.byte() != MSG_KEX_ECDH_REPLY:
            raise SSHError("expected KEX_ECDH_REPLY")
        k_s = r.string()
        q_s = r.string()
        sig_blob = r.string()
        shared = eph.exchange(X25519PublicKey.from_public_bytes(q_s))
        k_mpint = mpint(shared)
        h = self._exchange_hash(v_c, v_s, i_c, i_s, k_s, q_c, q_s, k_mpint)
        # verify the host signature over H (ssh-ed25519 blob)
        kr = Reader(k_s)
        if kr.string() != HOSTKEY_ALGO:
            raise SSHError("unexpected host key type")
        host_pub = Ed25519PublicKey.from_public_bytes(kr.string())
        sr = Reader(sig_blob)
        if sr.string() != HOSTKEY_ALGO:
            raise SSHError("unexpected signature type")
        try:
            host_pub.verify(sr.string(), h)
        except Exception as exc:
            raise SSHError(f"host key signature invalid: {exc}") from exc
        self.server_host_key_blob = k_s
        self._activate_keys(k_mpint, h)

    def _kex_server(self, v_c: bytes, v_s: bytes, i_c: bytes, i_s: bytes) -> None:
        from cryptography.hazmat.primitives.serialization import (
            Encoding,
            PublicFormat,
        )

        if self.host_key is None:
            raise SSHError("server transport needs a host key")
        r = Reader(self.recv_packet())
        if r.byte() != MSG_KEX_ECDH_INIT:
            raise SSHError("expected KEX_ECDH_INIT")
        q_c = r.string()
        eph = X25519PrivateKey.generate()
        q_s = eph.public_key().public_bytes(Encoding.Raw, PublicFormat.Raw)
        shared = eph.exchange(X25519PublicKey.from_public_bytes(q_c))
        k_mpint = mpint(shared)
        k_s = ed25519_blob(self.host_key.public_key())
        h = self._exchange_hash(v_c, v_s, i_c, i_s, k_s, q_c, q_s, k_mpint)
        sig = sstr(HOSTKEY_ALGO) + sstr(self.host_key.sign(h))
        self.send_packet(
            bytes([MSG_KEX_ECDH_REPLY]) + sstr(k_s) + sstr(q_s) + sstr(sig)
        )
        self._activate_keys(k_mpint, h)

    # -- client-side auth + channel ---------------------------------------
    def auth_password(self, username: str, password: str) -> None:
        self.send_packet(bytes([MSG_SERVICE_REQUEST]) + sstr(b"ssh-userauth"))
        r = Reader(self.recv_packet())
        if r.byte() != MSG_SERVICE_ACCEPT:
            raise SSHError("userauth service not accepted")
        self.send_packet(
            bytes([MSG_USERAUTH_REQUEST])
            + sstr(username.encode())
            + sstr(b"ssh-connection")
            + sstr(b"password")
            + b"\x00"
            + sstr(password.encode())
        )
        while True:
            r = Reader(self.recv_packet())
            t = r.byte()
            if t == MSG_USERAUTH_SUCCESS:
                return
            if t == MSG_USERAUTH_FAILURE:
                raise SSHAuthError(f"password authentication failed for {username}")
            if t in (MSG_IGNORE, MSG_DEBUG, MSG_USERAUTH_BANNER):
                continue  # banners (sshd Banner directive) are informational
            raise SSHError(f"unexpected userauth message {t}")

    def _recv_skipping_async(self) -> Reader:
        """Next packet, skipping asynchronous server chatter (OpenSSH sends
        hostkeys-00@openssh.com GLOBAL_REQUESTs right after auth)."""
        while True:
            payload = self.recv_packet()
            t = payload[0]
            if t in (MSG_IGNORE, MSG_DEBUG):
                continue
            if t == MSG_GLOBAL_REQUEST:
                r = Reader(payload)
                r.byte(), r.string()
                if r.boolean():  # want_reply
                    self.send_packet(bytes([MSG_REQUEST_FAILURE]))
                continue
            return Reader(payload)

    def open_sftp_channel(self) -> None:
        self.send_packet(
            bytes([MSG_CHANNEL_OPEN]) + sstr(b"session")
            + u32(self.local_channel) + u32(WINDOW_SIZE) + u32(MAX_PACKET)
        )
        r = self._recv_skipping_async()
        t = r.byte()
        if t != MSG_CHANNEL_OPEN_CONFIRMATION:
            raise SSHError(f"channel open failed (message {t})")
        r.uint32()  # recipient (us)
        self.remote_channel = r.uint32()
        self._send_window = r.uint32()
        self._remote_max_packet = r.uint32() or MAX_PACKET
        self.send_packet(
            bytes([MSG_CHANNEL_REQUEST]) + u32(self.remote_channel)
            + sstr(b"subsystem") + b"\x01" + sstr(b"sftp")
        )
        while True:
            payload = self.recv_packet()
            t = payload[0]
            if t == MSG_CHANNEL_SUCCESS:
                return
            if t == MSG_CHANNEL_FAILURE:
                raise SSHError("sftp subsystem request failed")
            self._dispatch_channel(payload)  # window adjusts may interleave

    # -- channel data plane (both roles) -----------------------------------
    def _dispatch_channel(self, payload: bytes) -> bool:
        """Handle a channel-plane message; returns True if consumed."""
        t = payload[0]
        r = Reader(payload)
        if t == MSG_CHANNEL_DATA:
            r.byte(), r.uint32()
            data = r.string()
            self._inbox.append(data)
            self._recv_window -= len(data)
            if self._recv_window < WINDOW_SIZE // 2:
                grant = WINDOW_SIZE - self._recv_window
                self._recv_window += grant
                self.send_packet(
                    bytes([MSG_CHANNEL_WINDOW_ADJUST])
                    + u32(self.remote_channel) + u32(grant)
                )
            return True
        if t == MSG_CHANNEL_WINDOW_ADJUST:
            r.byte(), r.uint32()
            self._send_window += r.uint32()
            return True
        if t in (MSG_CHANNEL_EOF, MSG_CHANNEL_CLOSE):
            self._eof = True
            return True
        if t in (MSG_IGNORE, MSG_DEBUG, MSG_GLOBAL_REQUEST):
            return True
        if t == MSG_DISCONNECT:
            raise SSHError("peer disconnected")
        return False

    def send_channel_data(self, data: bytes) -> None:
        view = memoryview(data)
        while view:
            while self._send_window <= 0:
                # pump incoming packets until the peer grants window
                payload = self.recv_packet()
                if not self._dispatch_channel(payload):
                    raise SSHError(
                        f"unexpected message {payload[0]} while blocked on window"
                    )
            # chunk bound honors the PEER's advertised maximum packet size
            # (RFC 4254 §5.2), not just our own — a non-gofr server may
            # negotiate a smaller cap (ADVICE r3). Floor of 1 keeps the
            # loop progressing even against a broken peer advertising ≤64.
            n = max(1, min(len(view), self._send_window,
                           min(self._remote_max_packet, MAX_PACKET) - 64))
            self._send_window -= n
            chunk = bytes(view[:n])
            view = view[n:]
            self.send_packet(
                bytes([MSG_CHANNEL_DATA]) + u32(self.remote_channel) + sstr(chunk)
            )

    def recv_channel_data(self) -> bytes:
        """Next CHANNEL_DATA payload (pumping the wire as needed)."""
        while True:
            if self._inbox:
                return self._inbox.pop(0)
            if self._eof:
                raise SSHError("channel closed")
            payload = self.recv_packet()
            if not self._dispatch_channel(payload):
                raise SSHError(f"unexpected message {payload[0]} on channel plane")

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


# ---------------------------------------------------------------- server glue
class SSHServerSession:
    """Server-side post-handshake driver: authenticate (password check
    callback), accept the session channel + sftp subsystem, then hand the
    channel plane to the subsystem loop."""

    def __init__(self, transport: SSHTransport,
                 check_password: Callable[[str, str], bool]) -> None:
        self.t = transport
        self.check_password = check_password
        self.username: str | None = None

    def accept(self) -> None:
        t = self.t
        # service request
        r = Reader(t.recv_packet())
        if r.byte() != MSG_SERVICE_REQUEST or r.string() != b"ssh-userauth":
            raise SSHError("expected ssh-userauth service request")
        t.send_packet(bytes([MSG_SERVICE_ACCEPT]) + sstr(b"ssh-userauth"))
        # password auth attempts
        while True:
            r = Reader(t.recv_packet())
            if r.byte() != MSG_USERAUTH_REQUEST:
                raise SSHError("expected userauth request")
            user = r.string().decode()
            r.string()  # service
            method = r.string()
            if method == b"password":
                r.boolean()
                password = r.string().decode()
                if self.check_password(user, password):
                    self.username = user
                    t.send_packet(bytes([MSG_USERAUTH_SUCCESS]))
                    break
            t.send_packet(
                bytes([MSG_USERAUTH_FAILURE]) + name_list(b"password") + b"\x00"
            )
        # channel open
        r = Reader(t.recv_packet())
        if r.byte() != MSG_CHANNEL_OPEN or r.string() != b"session":
            raise SSHError("expected session channel open")
        t.remote_channel = r.uint32()
        t._send_window = r.uint32()
        t._remote_max_packet = r.uint32() or MAX_PACKET
        t.send_packet(
            bytes([MSG_CHANNEL_OPEN_CONFIRMATION]) + u32(t.remote_channel)
            + u32(t.local_channel) + u32(WINDOW_SIZE) + u32(MAX_PACKET)
        )
        # subsystem request
        r = Reader(t.recv_packet())
        if r.byte() != MSG_CHANNEL_REQUEST:
            raise SSHError("expected channel request")
        r.uint32()
        if r.string() != b"subsystem":
            raise SSHError("expected subsystem request")
        want_reply = r.boolean()
        if r.string() != b"sftp":
            raise SSHError("only the sftp subsystem is served")
        if want_reply:
            t.send_packet(bytes([MSG_CHANNEL_SUCCESS]) + u32(t.remote_channel))
