"""ctypes bindings for the port's host native library.

``csrc/host_native.cpp`` holds the byte-level work of the columnar PUBLISH
ingress path: the MQTT frame scan, the columnar PUBLISH decode, the
intern-table mirror and the batched topic encode. It is built by the host
C++ compiler (``$CXX``, else ``c++`` or ``g++``; never nvcc) at first use
into ``build/emqx_tpu_torch/libhost_native-<digest>.so``, keyed by a
digest of the source and the flags, under a file lock so that concurrent
processes build it once.

``_frame_scan_py`` and ``_publish_decode_columnar_py`` are the pure-Python
mirrors of the scan and the decode, bit for bit; the tests hold the library
to them. They serve the callers only on a host with no C++ compiler, and
then visibly: ``available()`` says which implementation is active and the
first use logs it. A compiler that fails to build the source raises.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import logging
import os
import shutil
import subprocess
import threading
from typing import Optional

from emqx_tpu_torch.ops.build import BUILD_DIR, CSRC

log = logging.getLogger("emqx_tpu_torch.native")

SOURCE = CSRC / "host_native.cpp"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_lib: Optional[ctypes.CDLL] = None
_tried = False
_lock = threading.Lock()


def _compiler() -> Optional[str]:
    cxx = os.environ.get("CXX")
    if cxx:
        return shutil.which(cxx) or (cxx if os.path.isfile(cxx) else None)
    return shutil.which("c++") or shutil.which("g++")


def library_path():
    """Where the library for the current source and flags lives."""
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libhost_native-{digest}.so"


def _build(cxx: str, so) -> None:
    """Compile the library unless another process already did: one
    compiler under an exclusive file lock, into a temporary file that
    replaces the target when it is complete."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "host_native.lock", "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        try:
            if so.exists():
                return
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            out = subprocess.run(
                [cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                capture_output=True, text=True, timeout=300)
            if out.returncode != 0:
                raise RuntimeError(f"{cxx} failed for {SOURCE.name}:\n"
                                   f"{out.stdout}{out.stderr}")
            os.replace(tmp, so)
        finally:
            fcntl.flock(lk, fcntl.LOCK_UN)


def _declare(lib: ctypes.CDLL) -> None:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.mqtt_frame_scan.restype = ctypes.c_int
    lib.mqtt_frame_scan.argtypes = [
        u8p, ctypes.c_size_t, u32p, u32p, ctypes.c_int, ctypes.c_uint32,
        ctypes.POINTER(ctypes.c_size_t)]
    lib.mqtt_publish_decode_columnar.restype = ctypes.c_int
    lib.mqtt_publish_decode_columnar.argtypes = [
        u8p, ctypes.c_size_t, u32p, u32p, ctypes.c_int, ctypes.c_int,
        u8p, u8p, u32p, u32p, u32p, u32p, u32p, u32p, u32p]
    lib.intern_table_new.restype = ctypes.c_int
    lib.intern_table_new.argtypes = []
    lib.intern_table_free.restype = None
    lib.intern_table_free.argtypes = [ctypes.c_int]
    lib.intern_table_add.restype = ctypes.c_int
    lib.intern_table_add.argtypes = [ctypes.c_int, ctypes.c_char_p,
                                     ctypes.c_uint32, ctypes.c_int32]
    lib.topic_encode_batch.restype = ctypes.c_int
    lib.topic_encode_batch.argtypes = [
        ctypes.c_int, ctypes.c_char_p, u32p, u32p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int32, ctypes.c_int32, i32p, i32p, u8p, u8p]


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        so = library_path()
        if not so.exists():
            cxx = _compiler()
            if cxx is None:
                _tried = True
                log.warning("no C++ compiler: columnar ingress runs on the "
                            "pure-Python mirrors of %s", SOURCE.name)
                return None
            _build(cxx, so)
        lib = ctypes.CDLL(str(so))
        _declare(lib)
        _lib = lib
        _tried = True
        log.info("host native library loaded from %s", so)
        return _lib


def available() -> bool:
    """True when the native library is active, False when the callers
    run on the pure-Python mirrors (a host with no C++ compiler)."""
    return _load() is not None


# ---------------------------------------------------------------------
# frame scan
# ---------------------------------------------------------------------
class FrameScanError(Exception):
    pass


_U8P = ctypes.POINTER(ctypes.c_uint8)


def _buf_arg(buf):
    """A ctypes view of a buffer-protocol object without a copy where it
    can be had: writable buffers (bytearray, a memoryview of one) go
    through from_buffer, immutable bytes through the object's own
    pointer."""
    if isinstance(buf, bytes):
        return ctypes.cast(ctypes.c_char_p(buf), _U8P)
    try:
        return (ctypes.c_uint8 * len(buf)).from_buffer(buf)
    except (TypeError, ValueError):   # read-only memoryview etc.
        return (ctypes.c_uint8 * len(buf)).from_buffer_copy(buf)


def _scan_native(lib, buf, off_p, lens_p, max_frames, max_frame_size):
    n = len(buf)
    arr = _buf_arg(buf) if n else (ctypes.c_uint8 * 1)()
    consumed = ctypes.c_size_t(0)
    rc = lib.mqtt_frame_scan(arr, n, off_p, lens_p, max_frames,
                             max_frame_size, ctypes.byref(consumed))
    # release the from_buffer export before any raise: a traceback
    # holding this frame would otherwise pin the caller's bytearray
    del arr
    if rc == -1:
        raise FrameScanError("malformed varint")
    if rc == -2:
        raise FrameScanError("frame too large")
    return rc, consumed.value


def frame_scan(buf, max_frames: int = 256,
               max_frame_size: int = 0) -> tuple[list[tuple[int, int]],
                                                 int]:
    """Split a byte buffer into complete MQTT frames.

    Accepts any buffer-protocol object; a bytearray or memoryview is
    scanned in place. Returns ([(offset, length), ...], consumed). Raises
    FrameScanError on a malformed varint or an oversized frame."""
    lib = _load()
    if lib is None:
        return _frame_scan_py(buf, max_frames, max_frame_size)
    off = (ctypes.c_uint32 * max_frames)()
    lens = (ctypes.c_uint32 * max_frames)()
    rc, consumed = _scan_native(lib, buf, off, lens, max_frames,
                                max_frame_size)
    return [(off[i], lens[i]) for i in range(rc)], consumed


def frame_scan_np(buf, max_frames: int = 4096, max_frame_size: int = 0):
    """frame_scan returning numpy arrays, the columnar form:
    (off uint32[n], length uint32[n], consumed)."""
    import numpy as np
    lib = _load()
    if lib is None:
        frames, consumed = _frame_scan_py(buf, max_frames, max_frame_size)
        off = np.fromiter((f[0] for f in frames), np.uint32, len(frames))
        lens = np.fromiter((f[1] for f in frames), np.uint32, len(frames))
        return off, lens, consumed
    off = np.empty(max_frames, np.uint32)
    lens = np.empty(max_frames, np.uint32)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    rc, consumed = _scan_native(lib, buf, off.ctypes.data_as(u32p),
                                lens.ctypes.data_as(u32p), max_frames,
                                max_frame_size)
    return off[:rc], lens[:rc], consumed


def _frame_scan_py(buf: bytes, max_frames: int,
                   max_frame_size: int) -> tuple[list[tuple[int, int]],
                                                 int]:
    out: list[tuple[int, int]] = []
    pos = 0
    consumed = 0
    while pos + 2 <= len(buf) and len(out) < max_frames:
        p = pos + 1
        rem = 0
        mult = 1
        nbytes = 0
        complete = False
        while p < len(buf) and nbytes < 4:
            b = buf[p]
            p += 1
            rem += (b & 0x7F) * mult
            mult <<= 7
            nbytes += 1
            if not b & 0x80:
                complete = True
                break
        if not complete:
            if nbytes >= 4:
                raise FrameScanError("malformed varint")
            break
        total = (p - pos) + rem
        if max_frame_size and total > max_frame_size:
            raise FrameScanError("frame too large")
        if pos + total > len(buf):
            break
        out.append((pos, total))
        pos += total
        consumed = pos
    return out, consumed


# ---------------------------------------------------------------------
# columnar PUBLISH decode
# ---------------------------------------------------------------------
DECODE_COLUMNS = ("kind", "flags", "topic_off", "topic_len", "packet_id",
                  "props_off", "props_len", "payload_off", "payload_len")


def publish_decode_columnar(buf, off, lens, v5: bool):
    """Decode every PUBLISH frame among the scanned boundaries in one
    pass. ``off``/``lens`` are the uint32 arrays of frame_scan_np; returns
    a dict of parallel numpy arrays:

        kind        uint8[n]   1 = a columnar-decoded PUBLISH; 0 = a frame
                               for the strict per-packet parser (not a
                               PUBLISH, or one it must reject precisely)
        flags       uint8[n]   the fixed-header nibble (bit0 retain,
                               bits1-2 qos, bit3 dup)
        topic_off / topic_len / packet_id / props_off / props_len /
        payload_off / payload_len          uint32[n], absolute into buf

    kind=0 rows are zero in every other array. UTF-8 topic validation and
    v5 property parsing stay with the caller."""
    import numpy as np
    n = len(off)
    out = {k: np.zeros(n, np.uint8 if k in ("kind", "flags") else np.uint32)
           for k in DECODE_COLUMNS}
    if n == 0:
        return out
    lib = _load()
    if lib is None:
        return _publish_decode_columnar_py(buf, off, lens, v5, out)
    off = np.ascontiguousarray(off, np.uint32)
    lens = np.ascontiguousarray(lens, np.uint32)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    arr = _buf_arg(buf)
    lib.mqtt_publish_decode_columnar(
        arr, len(buf), off.ctypes.data_as(u32p), lens.ctypes.data_as(u32p),
        n, 1 if v5 else 0,
        *(out[k].ctypes.data_as(_U8P if k in ("kind", "flags") else u32p)
          for k in DECODE_COLUMNS))
    del arr
    return out


def _publish_decode_columnar_py(buf, off, lens, v5: bool, out):
    """Pure-Python mirror of mqtt_publish_decode_columnar, bit for bit."""
    kind = out["kind"]
    flags = out["flags"]
    topic_off = out["topic_off"]
    topic_len = out["topic_len"]
    packet_id = out["packet_id"]
    props_off = out["props_off"]
    props_len = out["props_len"]
    payload_off = out["payload_off"]
    payload_len = out["payload_len"]
    blen = len(buf)
    for i in range(len(off)):
        s = int(off[i])
        e = s + int(lens[i])
        if e > blen or lens[i] < 2:
            continue
        b0 = buf[s]
        if (b0 >> 4) != 3:
            continue
        qos = (b0 >> 1) & 0x3
        if qos == 3:
            continue
        p = s + 1
        nb = 0
        while p < e and nb < 4:
            b = buf[p]
            p += 1
            nb += 1
            if not (b & 0x80):
                break
        if p + 2 > e:
            continue
        tl = (buf[p] << 8) | buf[p + 1]
        p += 2
        if p + tl > e:
            continue
        t_off = p
        p += tl
        pid = 0
        if qos > 0:
            if p + 2 > e:
                continue
            pid = (buf[p] << 8) | buf[p + 1]
            p += 2
            if pid == 0:
                continue
        pr_off = pr_len = 0
        if v5:
            pl, mult, k, done = 0, 1, 0, False
            while p < e and k < 4:
                b = buf[p]
                p += 1
                pl += (b & 0x7F) * mult
                mult <<= 7
                k += 1
                if not (b & 0x80):
                    done = True
                    break
            if not done:
                continue
            if p + pl > e:
                continue
            pr_off, pr_len = p, pl
            p += pl
        topic_off[i] = t_off
        topic_len[i] = tl
        packet_id[i] = pid
        props_off[i] = pr_off
        props_len[i] = pr_len
        payload_off[i] = p
        payload_len[i] = e - p
        flags[i] = b0 & 0x0F
        kind[i] = 1
    return out


# ---------------------------------------------------------------------
# interned-word mirror + batched topic encode
# ---------------------------------------------------------------------
def intern_mirror_new() -> Optional[int]:
    """Allocate a native word -> id mirror; None when the library is not
    active or its handles are exhausted."""
    lib = _load()
    if lib is None:
        return None
    h = lib.intern_table_new()
    return h if h >= 0 else None


def intern_mirror_free(h: int) -> None:
    lib = _load()
    if lib is not None and h is not None and h >= 0:
        lib.intern_table_free(h)


def intern_mirror_add(h: int, word: str, wid: int) -> bool:
    """Mirror one word -> id. The table keeps the word's bytes and
    confirms lookups with memcmp, so two words sharing a hash take two
    probe slots; False only on an allocation failure, a dead handle or a
    second id for the same word (the caller then retires the mirror)."""
    raw = word.encode()
    return _load().intern_table_add(h, raw, len(raw), wid) == 0


def topic_encode_batch(h: int, topics: list, max_levels: int,
                       unknown_id: int, pad_id: int):
    """Encode publish topics in one native call: (ids [n, L] int32,
    lens [n] int32, dollar [n] bool, too_long [n] bool), or None when the
    library or the handle is not there."""
    lib = _load()
    if lib is None or h is None or not topics:
        return None
    import numpy as np
    raws = [t.encode() for t in topics]
    buf = b"".join(raws)
    n = len(raws)
    offs = np.zeros(n, np.uint32)
    lens_in = np.fromiter(map(len, raws), np.uint32, n)
    if n > 1:
        np.cumsum(lens_in[:-1], out=offs[1:])
    ids = np.empty((n, max_levels), np.int32)
    lens = np.empty(n, np.int32)
    dollar = np.empty(n, np.uint8)
    toolong = np.empty(n, np.uint8)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    rc = lib.topic_encode_batch(
        h, buf, offs.ctypes.data_as(u32p), lens_in.ctypes.data_as(u32p), n,
        max_levels, unknown_id, pad_id, ids.ctypes.data_as(i32p),
        lens.ctypes.data_as(i32p), dollar.ctypes.data_as(_U8P),
        toolong.ctypes.data_as(_U8P))
    if rc != n:
        return None
    return ids, lens, dollar.astype(bool), toolong.astype(bool)
