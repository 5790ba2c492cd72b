"""A minimal HDF5 reader and writer for SfM's feature and match files.

The port writes and reads the JAX package's HDF5 files (one group per
image or pair, numeric datasets) on machines that have no ``h5py``. This
module implements the part of the public HDF5 file format those files
use, as ``colmap_io.py`` implements COLMAP's:

- a version 0 superblock with 8-byte offsets and lengths;
- groups as symbol tables: a version 1 B-tree of group nodes, symbol
  table nodes (SNOD) and a local heap of names;
- version 1 object headers (and their continuation blocks);
- datasets of little-endian integers or IEEE floats in contiguous (or,
  when reading, compact) layout.

Files it writes are read by ``h5py``, and it reads the files ``h5py``
writes with its default (earliest) format (``tests/test_torch_hdf5.py``).
The API is the subset of ``h5py``'s the port calls: ``File(path, "r" or
"w")``, ``create_group`` and ``create_dataset`` (intermediate groups are
created), ``group[name]`` with ``/``-separated paths, ``name in group``,
iteration over a group's names in sorted order, ``dataset[()]``.

A written dataset's bytes go to the file when it is created; the groups'
structures and the superblock are written when the file is closed.
"""
from __future__ import annotations

import mmap
import struct
from typing import Dict, Iterator, Union

import numpy as np

UNDEF = 0xFFFFFFFFFFFFFFFF
SIGNATURE = b"\x89HDF\r\n\x1a\n"
SUPERBLOCK_SIZE = 96
# symbol table node capacity 2 * LEAF_K names, B-tree node fan-out
# 2 * INTERNAL_K: one B-tree level holds 8192 names a group
LEAF_K, INTERNAL_K = 32, 64

MSG_DATASPACE, MSG_DATATYPE, MSG_FILL = 0x1, 0x3, 0x5
MSG_LAYOUT, MSG_CONTINUATION, MSG_SYMBOL_TABLE = 0x8, 0x10, 0x11


def _pad8(n: int) -> int:
    return (n + 7) & ~7


def _split(path: str):
    return [p for p in path.split("/") if p]


# ---------------------------------------------------------------------------
# Reading
# ---------------------------------------------------------------------------

def _read_messages(buf: memoryview, base: int, addr: int, size: int,
                   out: list):
    """Version 1 object header messages in ``size`` bytes at ``addr``."""
    pos, end = addr - base, addr - base + size
    while pos + 8 <= end:
        mtype, msize = struct.unpack_from("<HH", buf, pos)
        out.append((mtype, pos + 8, msize))
        pos += 8 + msize


def _object_messages(buf: memoryview, addr: int) -> list:
    """[(type, offset of its data, size)] of the object header at
    ``addr``, continuation blocks followed."""
    version, _, nmsgs, _, hsize = struct.unpack_from("<BBHII", buf, addr)
    if version != 1:
        raise NotImplementedError(f"object header version {version}")
    msgs: list = []
    _read_messages(buf, 0, addr + 16, hsize, msgs)
    i = 0
    while i < len(msgs):
        mtype, off, _ = msgs[i]
        if mtype == MSG_CONTINUATION:
            caddr, clen = struct.unpack_from("<QQ", buf, off)
            _read_messages(buf, 0, caddr, clen, msgs)
        i += 1
    return msgs


def _dtype(buf: memoryview, off: int) -> np.dtype:
    cls_ver, b0 = struct.unpack_from("<BB", buf, off)
    size = struct.unpack_from("<I", buf, off + 4)[0]
    cls = cls_ver & 0x0F
    order = ">" if b0 & 1 else "<"
    if cls == 0:
        return np.dtype(f"{order}{'i' if b0 & 0x08 else 'u'}{size}")
    if cls == 1:
        return np.dtype(f"{order}f{size}")
    raise NotImplementedError(f"HDF5 datatype class {cls}")


def _shape(buf: memoryview, off: int):
    version, ndims = struct.unpack_from("<BB", buf, off)
    start = off + (8 if version == 1 else 4)
    return tuple(struct.unpack_from(f"<{ndims}Q", buf, start))


class Dataset:
    """A dataset: of a file open for reading (read at first use), or one
    written to a file (read back from it)."""

    def __init__(self, file, msgs=None, written=None):
        self._file = file
        self._msgs = msgs
        self._written = written      # (dtype, shape, address) once written
        self._data = None

    def read(self) -> np.ndarray:
        if self._data is not None:
            return self._data
        if self._written is None:
            self._data = self._file._read_dataset(self._msgs)
            return self._data
        dtype, shape, addr = self._written
        count = int(np.prod(shape, dtype=np.int64))
        if not count:
            return np.zeros(shape, dtype)
        fh = self._file._fh
        fh.seek(addr)
        data = np.frombuffer(fh.read(count * dtype.itemsize), dtype)
        fh.seek(0, 2)
        return data.reshape(shape)

    @property
    def shape(self):
        return self.read().shape

    @property
    def dtype(self):
        return self.read().dtype

    def __getitem__(self, key):
        return self.read()[key]

    def __len__(self):
        return len(self.read())


class Group:
    """A group: its members by name (subgroups and datasets)."""

    def __init__(self, file, members=None, loader=None):
        self._file = file
        self._members: Dict[str, Union["Group", Dataset]] = (
            members if members is not None else {})
        self._loader = loader

    def _items(self):
        if self._loader is not None:
            self._members, self._loader = self._loader(), None
        return self._members

    def _walk(self, path: str, create: bool = False):
        node = self
        for part in _split(path):
            items = node._items()
            if part not in items:
                if not create:
                    raise KeyError(path)
                items[part] = Group(self._file)
            node = items[part]
            if not isinstance(node, Group):
                raise KeyError(f"{path}: {part} is a dataset")
        return node

    def __getitem__(self, path: str):
        parts = _split(path)
        parent = self._walk("/".join(parts[:-1]))
        items = parent._items()
        if parts[-1] not in items:
            raise KeyError(path)
        return items[parts[-1]]

    def __contains__(self, path: str) -> bool:
        try:
            self[path]
            return True
        except KeyError:
            return False

    def __iter__(self) -> Iterator[str]:
        return iter(sorted(self._items(), key=lambda n: n.encode()))

    def __len__(self):
        return len(self._items())

    def create_group(self, path: str) -> "Group":
        self._file._check_writable()
        if path in self:
            raise ValueError(f"{path} already exists")
        return self._walk(path, create=True)

    def create_dataset(self, path: str, data) -> Dataset:
        self._file._check_writable()
        parts = _split(path)
        parent = self._walk("/".join(parts[:-1]), create=True)
        if parts[-1] in parent._items():
            raise ValueError(f"{path} already exists")
        arr = np.ascontiguousarray(np.asarray(data))
        if arr.dtype.kind not in "iuf":
            raise NotImplementedError(f"{path}: dtype {arr.dtype}")
        arr = arr.astype(arr.dtype.newbyteorder("<"), copy=False)
        addr = self._file._append(arr.tobytes()) if arr.size else UNDEF
        ds = Dataset(self._file, written=(arr.dtype, arr.shape, addr))
        parent._items()[parts[-1]] = ds
        return ds


class File(Group):
    """An HDF5 file, open for reading (``"r"``) or written anew
    (``"w"``)."""

    def __init__(self, path: str, mode: str = "r"):
        if mode not in ("r", "w"):
            raise ValueError(f"mode {mode!r}: 'r' or 'w'")
        self.mode = mode
        self._fh = open(path, "rb" if mode == "r" else "w+b")
        if mode == "w":
            super().__init__(self)
            self._fh.write(b"\0" * SUPERBLOCK_SIZE)
            self._end = SUPERBLOCK_SIZE
            return
        self._map = mmap.mmap(self._fh.fileno(), 0, access=mmap.ACCESS_READ)
        self._buf = data = memoryview(self._map)
        if data[:8] != SIGNATURE:
            raise OSError(f"{path}: not an HDF5 file")
        if data[8] != 0:
            raise NotImplementedError(f"{path}: superblock version {data[8]}")
        if data[13] != 8 or data[14] != 8:
            raise NotImplementedError(f"{path}: offsets and lengths not 8")
        root_header = struct.unpack_from("<Q", self._buf, 56 + 8)[0]
        super().__init__(self, loader=lambda: self._load_group(root_header))

    # -- reading -----------------------------------------------------------
    def _load_group(self, header: int) -> dict:
        buf = self._buf
        for mtype, off, _ in _object_messages(buf, header):
            if mtype == MSG_SYMBOL_TABLE:
                btree, heap = struct.unpack_from("<QQ", buf, off)
                break
        else:
            raise NotImplementedError("a group without a symbol table")
        if bytes(buf[heap:heap + 4]) != b"HEAP":
            raise OSError("bad local heap")
        size, _, data = struct.unpack_from("<QQQ", buf, heap + 8)
        names = bytes(buf[data:data + size])
        members = {}
        for name_off, obj in self._symbols(btree):
            name = names[name_off:names.index(b"\0", name_off)]
            members[name.decode()] = self._load_object(obj)
        return members

    def _symbols(self, node: int):
        buf = self._buf
        if bytes(buf[node:node + 4]) != b"TREE":
            raise OSError("bad B-tree node")
        _, level, used = struct.unpack_from("<BBH", buf, node + 4)
        for i in range(used):
            child = struct.unpack_from("<Q", buf, node + 24 + 8 + 16 * i)[0]
            if level > 0:
                yield from self._symbols(child)
                continue
            if bytes(buf[child:child + 4]) != b"SNOD":
                raise OSError("bad symbol table node")
            n = struct.unpack_from("<H", buf, child + 6)[0]
            for j in range(n):
                yield struct.unpack_from("<QQ", buf, child + 8 + 40 * j)

    def _load_object(self, header: int):
        msgs = _object_messages(self._buf, header)
        if any(m[0] == MSG_SYMBOL_TABLE for m in msgs):
            return Group(self, loader=lambda: self._load_group(header))
        return Dataset(self, msgs=msgs)

    def _read_dataset(self, msgs) -> np.ndarray:
        buf = self._buf
        found = {m[0]: m[1] for m in msgs}
        shape = _shape(buf, found[MSG_DATASPACE])
        dtype = _dtype(buf, found[MSG_DATATYPE])
        off = found[MSG_LAYOUT]
        version, cls = struct.unpack_from("<BB", buf, off)
        if version != 3:
            raise NotImplementedError(f"data layout version {version}")
        count = int(np.prod(shape, dtype=np.int64))
        if cls == 0:                                   # compact
            size = struct.unpack_from("<H", buf, off + 2)[0]
            raw = bytes(buf[off + 4:off + 4 + size])
        elif cls == 1:                                 # contiguous
            addr, size = struct.unpack_from("<QQ", buf, off + 2)
            if addr == UNDEF:
                return np.zeros(shape, dtype.newbyteorder("="))
            raw = bytes(buf[addr:addr + count * dtype.itemsize])
        else:
            raise NotImplementedError("chunked datasets")
        return np.frombuffer(raw, dtype, count).reshape(shape).astype(
            dtype.newbyteorder("="))

    # -- writing -----------------------------------------------------------
    def _check_writable(self):
        if self.mode != "w":
            raise OSError("file is open for reading")

    def _append(self, data: bytes) -> int:
        addr = self._end
        padded = data + b"\0" * (_pad8(len(data)) - len(data))
        self._fh.write(padded)
        self._end += len(padded)
        return addr

    def _object_header(self, messages) -> int:
        body = b""
        for mtype, data, flags in messages:
            size = _pad8(len(data))
            body += struct.pack("<HHB3x", mtype, size, flags)
            body += data + b"\0" * (size - len(data))
        head = struct.pack("<BBHII4x", 1, 0, len(messages), 1, len(body))
        return self._append(head + body)

    def _write_dataset(self, ds: Dataset) -> int:
        dt, shape, addr = ds._written
        space = struct.pack("<BBBB4x", 1, len(shape), 0, 0) + struct.pack(
            f"<{len(shape)}Q", *shape)
        size = dt.itemsize
        if dt.kind == "f":
            mant, exp = {2: (10, 5), 4: (23, 8), 8: (52, 11)}[size]
            dtype = struct.pack("<BBBBI", 0x11, 0x20, 8 * size - 1, 0, size)
            dtype += struct.pack("<HHBBBBI", 0, 8 * size, mant, exp, 0, mant,
                                 (1 << (exp - 1)) - 1)
        else:
            dtype = struct.pack("<BBBBI", 0x10, 0x08 if dt.kind == "i" else 0,
                                0, 0, size)
            dtype += struct.pack("<HH", 0, 8 * size)
        fill = struct.pack("<BBBB", 2, 2, 0, 0)
        nbytes = size * int(np.prod(shape, dtype=np.int64))
        layout = struct.pack("<BBQQ", 3, 1, addr, nbytes)
        return self._object_header([(MSG_DATASPACE, space, 1),
                                    (MSG_DATATYPE, dtype, 1),
                                    (MSG_FILL, fill, 1),
                                    (MSG_LAYOUT, layout, 0)])

    def _write_group(self, group: Group):
        """Write a group's members, then its heap, symbol table nodes,
        B-tree node and object header → (header, B-tree, heap)."""
        names = sorted(group._items(), key=lambda n: n.encode())
        if len(names) > 2 * LEAF_K * 2 * INTERNAL_K:
            raise NotImplementedError(f"more than {4 * LEAF_K * INTERNAL_K} "
                                      "members in one group")
        heap = bytearray(8)                            # offset 0: ""
        entries = []
        for name in names:
            member = group._items()[name]
            offset = len(heap)
            raw = name.encode() + b"\0"
            heap += raw + b"\0" * (_pad8(len(raw)) - len(raw))
            if isinstance(member, Group):
                header, btree, lheap = self._write_group(member)
                entries.append(struct.pack("<QQII2Q", offset, header, 1, 0,
                                           btree, lheap))
            else:
                entries.append(struct.pack("<QQII16x", offset,
                                           self._write_dataset(member), 0, 0))
        data_addr = self._append(bytes(heap))
        # free-list head 1: the format's "no free block" (HDF5's
        # H5HL_FREE_NULL)
        heap_addr = self._append(b"HEAP" + struct.pack(
            "<B3xQQQ", 0, len(heap), 1, data_addr))

        keys, children = [0], []
        for start in range(0, len(entries), 2 * LEAF_K):
            chunk = entries[start:start + 2 * LEAF_K]
            snod = b"SNOD" + struct.pack("<BBH", 1, 0, len(chunk))
            snod += b"".join(chunk) + b"\0" * (40 * (2 * LEAF_K - len(chunk)))
            children.append(self._append(snod))
            keys.append(struct.unpack_from("<Q", chunk[-1])[0])
        node = b"TREE" + struct.pack("<BBHQQ", 0, 0, len(children), UNDEF,
                                     UNDEF)
        for key, child in zip(keys, children):
            node += struct.pack("<QQ", key, child)
        node += struct.pack("<Q", keys[-1])
        full = 24 + 8 * (2 * INTERNAL_K + 1) + 8 * 2 * INTERNAL_K
        btree_addr = self._append(node + b"\0" * (full - len(node)))
        header = self._object_header([(MSG_SYMBOL_TABLE, struct.pack(
            "<QQ", btree_addr, heap_addr), 0)])
        return header, btree_addr, heap_addr

    def close(self):
        if self._fh.closed:
            return
        if self.mode == "r":
            self._members, self._loader = {}, None
            self._buf.release()
            self._map.close()
        else:
            header, btree, heap = self._write_group(self)
            sb = SIGNATURE + struct.pack("<8B", 0, 0, 0, 0, 0, 8, 8, 0)
            sb += struct.pack("<HHI", LEAF_K, INTERNAL_K, 0)
            sb += struct.pack("<QQQQ", 0, UNDEF, self._end, UNDEF)
            sb += struct.pack("<QQII2Q", 0, header, 1, 0, btree, heap)
            self._fh.seek(0)
            self._fh.write(sb)
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
