"""RecordIO: MXNet's packed binary dataset format (the port's copy of
``mxnet_tpu/recordio.py``).

``MXRecordIO``, ``MXIndexedRecordIO``, ``IRHeader`` and ``pack``/``unpack``
are plain Python file IO and numpy; ``pack_img``/``unpack_img`` encode and
decode with cv2, as MXNet's do.  The on-disk format is a protocol, so a
``.rec``/``.idx`` pair written by either package (or by MXNet's
``tools/im2rec.py``) reads in the other byte for byte:

- framing: ``uint32 magic=0xced7230a``, ``uint32 lrec`` (upper 3 bits =
  continuation flag, lower 29 = payload length), payload, zero-padding to a
  4-byte boundary; multi-part records use cflag 1(start)/2(middle)/3(end).
- ``IRHeader``: ``struct 'IfQQ'`` (flag, label, id, id2); when ``flag > 0``
  the scalar label is unused and ``flag`` float32 labels follow the header.

Nothing here touches torch: the decode worker processes of
``io/pipeline.py`` read records through this module.
"""
from __future__ import annotations

import collections
import os
import struct

import numpy as np

__all__ = ["MXRecordIO", "MXIndexedRecordIO", "IRHeader", "pack", "unpack",
           "pack_img", "unpack_img"]

_MAGIC = 0xced7230a
_CFLAG_BITS = 29
_LEN_MASK = (1 << _CFLAG_BITS) - 1


def _encode_lrec(cflag, length):
    return (cflag << _CFLAG_BITS) | length


def _decode_lrec(lrec):
    return lrec >> _CFLAG_BITS, lrec & _LEN_MASK


class MXRecordIO:
    """Sequential ``.rec`` reader/writer (reference ``recordio.py:36``)."""

    def __init__(self, uri, flag):
        self.uri = uri
        self.flag = flag
        self.record = None
        self.is_open = False
        self.open()

    def open(self):
        if self.flag == "w":
            self.record = open(self.uri, "wb")
            self.writable = True
        elif self.flag == "r":
            self.record = open(self.uri, "rb")
            self.writable = False
        else:
            raise ValueError("Invalid flag %s" % self.flag)
        self.is_open = True

    def __del__(self):
        self.close()

    def __getstate__(self):
        """Pickle without the file handle; the copy reopens the file
        (reference ``recordio.py:91``).  Unlike the reference, this object
        stays open: ``DataLoader`` pickles a dataset once per spawned
        worker, and closing here would hand every worker after the first a
        closed reader."""
        d = dict(self.__dict__)
        d["record"] = None
        return d

    def __setstate__(self, d):
        self.__dict__ = d
        is_open = d["is_open"]
        self.is_open = False
        if is_open:
            self.open()

    def close(self):
        if self.is_open:
            self.record.close()
            self.is_open = False

    def reset(self):
        self.close()
        self.open()

    def write(self, buf):
        assert self.writable
        length = len(buf)
        self.record.write(struct.pack("<II", _MAGIC,
                                      _encode_lrec(0, length)))
        self.record.write(buf)
        pad = (4 - length % 4) % 4
        if pad:
            self.record.write(b"\x00" * pad)

    def tell(self):
        assert self.writable
        self.record.flush()
        return self.record.tell()

    def read(self):
        assert not self.writable
        parts = []
        while True:
            hdr = self.record.read(8)
            if len(hdr) < 8:
                return None
            magic, lrec = struct.unpack("<II", hdr)
            if magic != _MAGIC:
                raise IOError(f"invalid record magic {magic:#x} in {self.uri}")
            cflag, length = _decode_lrec(lrec)
            data = self.record.read(length)
            if len(data) < length:
                raise IOError("truncated record in %s" % self.uri)
            pad = (4 - length % 4) % 4
            if pad:
                self.record.read(pad)
            if cflag == 0:
                return data
            parts.append(data)
            if cflag == 3:
                return b"".join(parts)


class MXIndexedRecordIO(MXRecordIO):
    """``.rec`` + ``.idx`` random-access pair (reference ``recordio.py:156``).

    The ``.idx`` text format is ``key<TAB>byte-offset`` per line.
    """

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
        if not self.writable and os.path.isfile(self.idx_path):
            with open(self.idx_path) as fin:
                for line in fin:
                    parts = line.strip().split("\t")
                    if len(parts) < 2:
                        continue
                    key = self.key_type(parts[0])
                    self.idx[key] = int(parts[1])
                    self.keys.append(key)
        if self.writable:
            self.fidx = open(self.idx_path, "w")

    def close(self):
        if self.is_open and self.fidx is not None:
            self.fidx.close()
            self.fidx = None
        super().close()

    def __getstate__(self):
        d = super().__getstate__()
        d["fidx"] = None
        return d

    def seek(self, idx):
        assert not self.writable
        self.record.seek(self.idx[idx])

    def read_idx(self, idx):
        self.seek(idx)
        return self.read()

    def write_idx(self, idx, buf):
        key = self.key_type(idx)
        pos = self.tell()
        self.write(buf)
        self.fidx.write("%s\t%d\n" % (str(key), pos))
        self.idx[key] = pos
        self.keys.append(key)


IRHeader = collections.namedtuple("HEADER", ["flag", "label", "id", "id2"])
_IR_FORMAT = "IfQQ"
_IR_SIZE = struct.calcsize(_IR_FORMAT)


def pack(header, s):
    """Serialize header + payload (reference ``recordio.py:383``)."""
    header = IRHeader(*header)
    if isinstance(header.label, (int, float)):
        header = header._replace(label=float(header.label))
        return struct.pack(_IR_FORMAT, *header) + s
    label = np.asarray(header.label, dtype=np.float32)
    header = header._replace(flag=label.size, label=0.0)
    return struct.pack(_IR_FORMAT, *header) + label.tobytes() + s


def unpack(s):
    """Deserialize → (IRHeader, payload) (reference ``recordio.py:415``)."""
    header = IRHeader(*struct.unpack(_IR_FORMAT, s[:_IR_SIZE]))
    s = s[_IR_SIZE:]
    if header.flag > 0:
        label = np.frombuffer(s[:header.flag * 4], dtype=np.float32)
        header = header._replace(label=label)
        s = s[header.flag * 4:]
    return header, s


def pack_img(header, img, quality=95, img_fmt=".jpg"):
    """Header + encoded image (reference ``recordio.py:437``; cv2-backed like
    the reference)."""
    import cv2
    if img_fmt.lower() in (".jpg", ".jpeg"):
        encode_params = [cv2.IMWRITE_JPEG_QUALITY, quality]
    elif img_fmt.lower() == ".png":
        encode_params = [cv2.IMWRITE_PNG_COMPRESSION, quality]
    else:
        encode_params = None
    ret, buf = cv2.imencode(img_fmt, img, encode_params)
    assert ret, "failed to encode image"
    return pack(header, buf.tobytes())


def unpack_img(s, iscolor=-1):
    """→ (IRHeader, BGR ndarray) (reference ``recordio.py:470``)."""
    import cv2
    header, s = unpack(s)
    img = np.frombuffer(s, dtype=np.uint8)
    img = cv2.imdecode(img, iscolor)
    return header, img
