"""Reader of joblib's file format, without joblib.

The JAX package reads the reference's feature DBs (``*_db.pt``,
``h36m_*_imgfeat_db_concat.pt``) with ``joblib.load``; the GPU machine has
no joblib, so the port reads the format itself. No JAX counterpart.

A joblib file is a pickle in which every numpy array was replaced by a
``NumpyArrayWrapper`` (``joblib.numpy_pickle``) holding its subclass, shape,
order and dtype. For a dtype without objects the array's bytes follow in the
stream right after the wrapper's BUILD opcode: since joblib 1.2 one byte of
padding length and that many ``0xff`` bytes come first, so that the data
start on a 16-byte boundary (``NumpyArrayWrapper.write_array`` /
``read_array``). An object array (names) is a whole protocol-5 pickle at
that place. Files of joblib < 0.10 pickle an ``NDArrayWrapper`` that names a
companion ``.npy`` file beside the main one.

A compressed file is the same stream through zlib, gzip, bz2, lzma or xz,
recognised by its magic bytes and decoded with the standard library. An
lz4 file, a pre-0.10 ``ZF`` file or anything else raises an error that
names the file. Only numpy's classes (and ``collections.OrderedDict``) may
be unpickled: a feature DB holds arrays, lists, dicts and strings.
"""

from __future__ import annotations

import bz2
import gzip
import io
import lzma
import os
import pickle
import struct
import zlib

import numpy as np

# Magic bytes of joblib's compressors (joblib/compressor.py).
_ZLIB, _GZIP, _BZ2 = b"\x78", b"\x1f\x8b", b"BZ"
_XZ, _LZMA = b"\xfd\x37\x7a\x58\x5a", b"\x5d\x00"
_LZ4, _ZFILE = b"\x04\x22\x4d\x18", b"ZF"


class JoblibFormatError(ValueError):
    """A file this reader cannot decode; the message names the file."""


class _ArrayWrapper:
    """Stand-in for ``NumpyArrayWrapper``: carries its pickled state."""

    def __setstate__(self, state):
        self.__dict__.update(state)


class _CompanionWrapper(_ArrayWrapper):
    """Stand-in for joblib < 0.10's ``NDArrayWrapper``."""


class _ZlibReader(io.RawIOBase):
    """A zlib stream (joblib's ``BinaryZlibFile``) decoded as it is read."""

    def __init__(self, raw):
        self._raw = raw
        self._dec = zlib.decompressobj()
        self._buf = b""

    def readable(self):
        return True

    def readinto(self, b):
        while not self._buf and not self._dec.eof:
            chunk = self._raw.read(1 << 20)
            self._buf = (self._dec.decompress(chunk) if chunk
                         else self._dec.flush())
            if not chunk:
                break
        n = min(len(b), len(self._buf))
        b[:n] = self._buf[:n]
        self._buf = self._buf[n:]
        return n


def _open_stream(raw, path: str):
    """The decoded stream of ``raw`` (an open binary file) by its magic."""
    head = raw.read(5)
    raw.seek(0)
    if head.startswith(_LZ4):
        raise JoblibFormatError(
            f"{path}: lz4-compressed joblib file (the standard library has "
            f"no lz4 decoder); re-save it uncompressed or with zlib")
    if head.startswith(_ZFILE):
        raise JoblibFormatError(
            f"{path}: joblib < 0.10 'ZF' compressed file, not supported; "
            f"re-save it with a newer joblib")
    if head.startswith(_GZIP):
        return gzip.GzipFile(fileobj=raw, mode="rb")
    if head.startswith(_BZ2):
        return bz2.BZ2File(raw, mode="rb")
    if head.startswith(_XZ) or head.startswith(_LZMA):
        return lzma.LZMAFile(raw, mode="rb")
    if head.startswith(_ZLIB):
        return io.BufferedReader(_ZlibReader(raw))
    if head[:1] == pickle.PROTO:
        return raw
    raise JoblibFormatError(f"{path}: not a joblib file (starts "
                            f"{head!r})")


def _read_exact(stream, nbytes: int, path: str) -> np.ndarray:
    buf = np.empty(nbytes, np.uint8)
    view, got = memoryview(buf), 0
    while got < nbytes:
        n = stream.readinto(view[got:])
        if not n:
            raise JoblibFormatError(
                f"{path}: truncated: an array needs {nbytes} bytes, the "
                f"file holds {got}")
        got += n
    return buf


def _numpy_class(find_class, module, name, path):
    """Only numpy's classes and ``OrderedDict`` are unpickled."""
    if (module.split(".")[0] == "numpy"
            or (module, name) == ("collections", "OrderedDict")):
        return find_class(module, name)
    raise JoblibFormatError(
        f"{path}: refusing to unpickle {module}.{name} (a feature DB holds "
        f"numpy arrays, lists, dicts and strings)")


class _ObjectArrayUnpickler(pickle.Unpickler):
    """The protocol-5 pickle of an object array, numpy's classes only."""

    def __init__(self, stream, path: str):
        super().__init__(stream)
        self._path = path

    def find_class(self, module, name):
        return _numpy_class(super().find_class, module, name, self._path)


class _Unpickler(pickle._Unpickler):
    """joblib's ``NumpyUnpickler`` without joblib: the wrappers become
    their arrays at their BUILD opcode (the Python unpickler, whose
    dispatch table can be extended, reads the stream no further than it
    must)."""

    dispatch = pickle._Unpickler.dispatch.copy()

    def __init__(self, stream, path: str):
        super().__init__(stream)
        self._stream = stream
        self._path = path

    def find_class(self, module, name):
        if name == "NumpyArrayWrapper" and module.endswith("numpy_pickle"):
            return _ArrayWrapper
        if (name == "NDArrayWrapper"
                and module.endswith("numpy_pickle_compat")):
            return _CompanionWrapper
        return _numpy_class(super().find_class, module, name, self._path)

    def load_build(self):
        super().load_build()
        top = self.stack[-1]
        if isinstance(top, _CompanionWrapper):
            self.stack[-1] = self._companion(top)
        elif isinstance(top, _ArrayWrapper):
            self.stack[-1] = self._array(top)

    dispatch[pickle.BUILD[0]] = load_build

    def _array(self, w: _ArrayWrapper) -> np.ndarray:
        dtype = np.dtype(w.dtype)
        if dtype.hasobject:
            return _ObjectArrayUnpickler(self._stream, self._path).load()
        if getattr(w, "numpy_array_alignment_bytes", None) is not None:
            pad = _read_exact(self._stream, 1, self._path)[0]
            _read_exact(self._stream, int(pad), self._path)
        shape = tuple(int(s) for s in w.shape)
        count = int(np.prod(shape, dtype=np.int64))
        arr = _read_exact(self._stream, count * dtype.itemsize,
                          self._path).view(dtype)
        if w.order == "F":
            arr = arr.reshape(shape[::-1]).transpose()
        else:
            arr = arr.reshape(shape)
        if not dtype.isnative:
            arr = arr.byteswap().view(dtype.newbyteorder("="))
        return arr

    def _companion(self, w: _CompanionWrapper) -> np.ndarray:
        name = os.path.join(os.path.dirname(self._path), w.filename)
        return np.load(name, allow_pickle=True)


def load(path) -> object:
    """The object ``joblib.dump`` stored in ``path`` (arrays as numpy
    arrays in native byte order)."""
    path = os.fspath(path)
    with open(path, "rb") as raw:
        stream = _open_stream(raw, path)
        try:
            return _Unpickler(stream, path).load()
        except (EOFError, pickle.UnpicklingError, struct.error, zlib.error,
                OSError, lzma.LZMAError) as exc:
            raise JoblibFormatError(
                f"{path}: truncated or corrupt joblib file ({exc})") from exc
        finally:
            if stream is not raw:
                stream.close()
