"""RecordIO of the PyTorch port.

Counterpart of ``mxnet_tpu/recordio.py:27-210`` (reference:
python/mxnet/recordio.py over dmlc-core's recordio): a record is the
magic ``0xCED7230A``, its length (two little-endian uint32) and its
bytes, padded to 4 bytes; an ``.idx`` file has a line ``key\\tpos`` a
record.  :func:`pack` puts an :class:`IRHeader` (flag, label, id, id2:
``IfQQ``) before the payload, a label vector after the header when
``flag`` > 0.  Files and ``.idx`` files are byte for byte the JAX
package's for the same records.

:func:`pack_img` encodes an HWC uint8 image (RGB) as JPEG or PNG through
PIL, else cv2; :func:`unpack_img` decodes it the same way (and the JAX
package's raw ``RAW0`` records, which it writes when it has no encoder).
PIL comes first, as in the JAX package's ``pack_img``/``unpack_img``
(which use PIL alone), so that the two packages' files and decoded
pixels are equal where PIL imports; with neither, both raise
:class:`MXNetError`.
"""

from __future__ import annotations

import importlib.util
import io
import os
import struct
from collections import namedtuple

import numpy as np

from .base import MXNetError

__all__ = ["MXRecordIO", "MXIndexedRecordIO", "IRHeader", "pack", "unpack",
           "pack_img", "unpack_img"]

_MAGIC = 0xCED7230A

IRHeader = namedtuple("HEADER", ["flag", "label", "id", "id2"])
_IR_FORMAT = "IfQQ"
_IR_SIZE = struct.calcsize(_IR_FORMAT)


class MXRecordIO:
    """A record file read (``flag`` ``"r"``) or written (``"w"``) in
    sequence."""

    def __init__(self, uri, flag):
        self.uri = uri
        self.flag = flag
        self.handle = None
        self.writable = flag == "w"
        self.is_open = False
        self.open()

    def open(self):
        self.handle = open(self.uri, "wb" if self.writable else "rb")
        self.is_open = True

    def close(self):
        if self.is_open:
            self.handle.close()
            self.is_open = False

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def __getstate__(self):
        d = dict(self.__dict__)
        d["handle"] = None
        if not self.writable:
            d["_pos"] = self.handle.tell() if self.is_open else 0
        return d

    def __setstate__(self, d):
        pos = d.pop("_pos", 0)
        self.__dict__.update(d)
        self.open()
        if not self.writable:
            self.handle.seek(pos)

    def reset(self):
        self.close()
        self.open()

    def write(self, buf):
        assert self.writable
        self.handle.write(struct.pack("<II", _MAGIC, len(buf)))
        self.handle.write(buf)
        pad = (4 - len(buf) % 4) % 4
        if pad:
            self.handle.write(b"\x00" * pad)

    def read(self):
        """The next record's bytes, or None at the end of the file; a
        truncated header or payload raises ``IOError``."""
        assert not self.writable
        head = self.handle.read(8)
        if not head:
            return None
        if len(head) < 8:
            raise IOError("truncated RecordIO header in %s (%d trailing "
                          "bytes)" % (self.uri, len(head)))
        magic, length = struct.unpack("<II", head)
        if magic != _MAGIC:
            raise IOError("invalid RecordIO magic in %s" % self.uri)
        buf = self.handle.read(length)
        if len(buf) < length:
            raise IOError("truncated RecordIO payload in %s (record wants "
                          "%d bytes, file has %d)"
                          % (self.uri, length, len(buf)))
        pad = (4 - length % 4) % 4
        if pad:
            self.handle.read(pad)
        return buf

    def tell(self):
        return self.handle.tell()

    def seek(self, pos):
        self.handle.seek(pos)


class MXIndexedRecordIO(MXRecordIO):
    """A record file with its ``.idx`` (``key\\tpos`` lines), read by
    key."""

    def __init__(self, idx_path, uri, flag, key_type=int):
        self.idx_path = idx_path
        self.idx = {}
        self.keys = []
        self.key_type = key_type
        self.fidx = None
        super().__init__(uri, flag)

    def open(self):
        super().open()
        self.idx = {}
        self.keys = []
        if not self.writable and os.path.exists(self.idx_path):
            with open(self.idx_path) as fin:
                for line in fin:
                    parts = line.strip().split("\t")
                    key = self.key_type(parts[0])
                    self.idx[key] = int(parts[1])
                    self.keys.append(key)
        if self.writable:
            self.fidx = open(self.idx_path, "w")

    def close(self):
        if self.fidx is not None and not self.fidx.closed:
            self.fidx.close()
        super().close()

    def read_idx(self, idx):
        self.seek(self.idx[idx])
        return self.read()

    def write_idx(self, idx, buf):
        key = self.key_type(idx)
        pos = self.tell()
        self.write(buf)
        self.fidx.write("%s\t%d\n" % (str(key), pos))
        self.idx[key] = pos
        self.keys.append(key)


def pack(header, s):
    """``header`` (an :class:`IRHeader`; a scalar label, or a vector
    written after it with ``flag`` its length) and the payload ``s``."""
    header = IRHeader(*header)
    if isinstance(header.label, (int, float)):
        return struct.pack(_IR_FORMAT, 0, float(header.label), header.id,
                           header.id2) + s
    label = np.asarray(header.label, dtype=np.float32)
    return struct.pack(_IR_FORMAT, label.size, 0.0, header.id,
                       header.id2) + label.tobytes() + s


def unpack(s):
    """``(IRHeader, payload)`` of a packed record; a vector label is a
    float32 array."""
    flag, label, id_, id2 = struct.unpack(_IR_FORMAT, s[:_IR_SIZE])
    s = s[_IR_SIZE:]
    if flag > 0:
        label = np.frombuffer(s[:flag * 4], dtype=np.float32)
        s = s[flag * 4:]
    return IRHeader(flag, label, id_, id2), s


def codec(order=("PIL", "cv2")):
    """The first image codec of ``order`` this host has, or None (found
    without importing it)."""
    for name in order:
        if importlib.util.find_spec(name) is not None:
            return name
    return None


def _no_codec(what):
    return MXNetError("%s needs an image codec: neither cv2 (OpenCV) nor "
                      "PIL (Pillow) imports on this host" % what)


def pack_img(header, img, quality=95, img_fmt=".jpg"):
    """``header`` and the HWC uint8 RGB image ``img`` encoded as JPEG (at
    ``quality``) or PNG, by PIL, else cv2."""
    jpeg = img_fmt.lower() in (".jpg", ".jpeg")
    kind = codec()
    if kind == "cv2":
        import cv2

        arr = np.ascontiguousarray(img[:, :, ::-1] if img.ndim == 3 else img)
        params = [cv2.IMWRITE_JPEG_QUALITY, quality] if jpeg else \
            [cv2.IMWRITE_PNG_COMPRESSION, 3]
        ok, buf = cv2.imencode(".jpg" if jpeg else ".png", arr, params)
        if not ok:
            raise MXNetError("pack_img: cv2 failed to encode the image")
        return pack(header, buf.tobytes())
    if kind == "PIL":
        from PIL import Image

        buff = io.BytesIO()
        Image.fromarray(img).save(buff, format="JPEG" if jpeg else "PNG",
                                  quality=quality)
        return pack(header, buff.getvalue())
    raise _no_codec("pack_img")


def unpack_img(s, iscolor=-1):
    """``(IRHeader, HWC uint8 array)`` of a record :func:`pack_img` (or
    the JAX package's raw fallback) wrote; a colour image comes back
    RGB."""
    del iscolor
    header, payload = unpack(s)
    if payload[:4] == b"RAW0":
        h, w, c = struct.unpack("<III", payload[4:16])
        img = np.frombuffer(payload[16:16 + h * w * c], dtype=np.uint8)
        return header, img.reshape((h, w, c) if c > 1 else (h, w))
    return header, decode_payload(payload)


def decode_payload(payload):
    """The HWC uint8 array (RGB when in colour) of an encoded image,
    by PIL, else cv2."""
    if payload[:4] == b"IMG0":
        payload = payload[4:]
    kind = codec()
    if kind == "cv2":
        import cv2

        img = cv2.imdecode(np.frombuffer(payload, dtype=np.uint8),
                           cv2.IMREAD_UNCHANGED)
        if img is None:
            raise MXNetError("unpack_img: cv2 failed to decode the record")
        return img[:, :, ::-1] if img.ndim == 3 else img
    if kind == "PIL":
        from PIL import Image

        return np.asarray(Image.open(io.BytesIO(payload)))
    raise _no_codec("unpack_img")
