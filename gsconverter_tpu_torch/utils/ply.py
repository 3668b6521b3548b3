"""Minimal, fast PLY container reader/writer (host-side IO shell).

The reference delegates PLY container work to the ``plyfile`` package; this
environment has none, and the codec layer only needs a small, fast subset:
multi-element PLY with scalar properties (vectorized numpy frombuffer path)
plus a generic slow path for list properties so extra elements (cameras,
faces, ...) survive passthrough (reference ply_3dgs.py:16,113-118).

Format behavior matched to the reference output: binary_little_endian 1.0
(reference writes PlyData(..., byte_order='<'), ply_3dgs.py:120).
"""

from __future__ import annotations

import dataclasses
import io
import mmap

import numpy as np

# PLY type name <-> numpy dtype (little-endian on disk).
_PLY_TO_NP = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}
_NP_TO_PLY = {
    "int8": "char", "uint8": "uchar",
    "int16": "short", "uint16": "ushort",
    "int32": "int", "uint32": "uint",
    "float32": "float", "float64": "double",
}


@dataclasses.dataclass
class PlyElement:
    """One parsed PLY element: structured numpy data + optional list props."""

    name: str
    data: np.ndarray  # structured array of scalar properties
    # list properties: name -> (count_dtype, item_dtype, list of per-row arrays)
    list_props: dict[str, tuple[str, str, list]] = dataclasses.field(
        default_factory=dict
    )

    @property
    def count(self) -> int:
        return len(self.data)


@dataclasses.dataclass
class PlyFile:
    elements: list[PlyElement]
    comments: list[str] = dataclasses.field(default_factory=list)

    def __contains__(self, name: str) -> bool:
        return any(e.name == name for e in self.elements)

    def __getitem__(self, name: str) -> PlyElement:
        for e in self.elements:
            if e.name == name:
                return e
        raise KeyError(name)


def _np_type_name(dt: np.dtype) -> str:
    name = np.dtype(dt).newbyteorder("=").name
    if name not in _NP_TO_PLY:
        raise ValueError(f"unsupported PLY dtype: {dt}")
    return _NP_TO_PLY[name]


def read_header(f) -> tuple[list, str, list[str]]:
    """Parse the PLY header. Returns (element specs, fmt, comments)."""
    magic = f.readline().strip()
    if magic != b"ply":
        raise ValueError("not a PLY file")
    fmt = None
    comments: list[str] = []
    elements = []  # list of (name, count, [(prop_name, kind)...])
    while True:
        line = f.readline()
        if not line:
            raise ValueError("unexpected EOF in PLY header")
        tokens = line.decode("ascii", errors="replace").strip().split()
        if not tokens:
            continue
        kw = tokens[0]
        if kw == "format":
            fmt = tokens[1]
        elif kw == "comment" or kw == "obj_info":
            comments.append(" ".join(tokens[1:]))
        elif kw == "element":
            elements.append((tokens[1], int(tokens[2]), []))
        elif kw == "property":
            if tokens[1] == "list":
                count_t, item_t, pname = tokens[2], tokens[3], tokens[4]
                elements[-1][2].append((pname, ("list", count_t, item_t)))
            else:
                elements[-1][2].append((tokens[2], ("scalar", tokens[1])))
        elif kw == "end_header":
            break
    if fmt not in ("binary_little_endian", "binary_big_endian", "ascii"):
        raise ValueError(f"unsupported PLY format: {fmt}")
    return elements, fmt, comments


def read(path: str) -> PlyFile:
    """Parse a PLY file.

    Binary little-endian files (the reference's output format) are memory-
    mapped and the element arrays are ZERO-COPY views over the mapping —
    ``f.read()`` would page in and copy the whole body up front, while the
    mmap path defers the page-ins to whichever downstream pass first
    touches each column.  The views are read-only; the codec
    layer copies exactly the columns it must (ply_gs.cloud_from_vertex_array).
    """
    with open(path, "rb") as f:
        specs, fmt, comments = read_header(f)
        data_offset = f.tell()
        if fmt == "binary_little_endian":
            try:
                body = memoryview(
                    mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
                )[data_offset:]
            except (ValueError, OSError):  # empty/special files
                body = f.read()
        else:
            body = f.read()
    out: list[PlyElement] = []
    if fmt == "ascii":
        out = _read_ascii(body, specs)
    else:
        endian = "<" if fmt == "binary_little_endian" else ">"
        offset = 0
        for name, count, props in specs:
            has_list = any(kind[0] == "list" for _, kind in props)
            if not has_list:
                dt = np.dtype(
                    [(pname, endian + _PLY_TO_NP[kind[1]]) for pname, kind in props]
                )
                arr = np.frombuffer(body, dtype=dt, count=count, offset=offset)
                offset += dt.itemsize * count
                if endian == ">":
                    arr = arr.astype(arr.dtype.newbyteorder("="))
                out.append(PlyElement(name, np.ascontiguousarray(arr)))
            else:
                elem, offset = _read_binary_with_lists(
                    body, offset, name, count, props, endian
                )
                out.append(elem)
    return PlyFile(out, comments)


def _read_binary_with_lists(body, offset, name, count, props, endian):
    scalar_props = [(p, k[1]) for p, k in props if k[0] == "scalar"]
    scalar_dt = np.dtype([(p, endian + _PLY_TO_NP[t]) for p, t in scalar_props])
    scalars = np.zeros(count, dtype=scalar_dt) if scalar_props else np.zeros(count, dtype=[("_", "u1")])
    lists: dict[str, tuple[str, str, list]] = {
        p: (k[1], k[2], []) for p, k in props if k[0] == "list"
    }
    for i in range(count):
        for pname, kind in props:
            if kind[0] == "scalar":
                npdt = np.dtype(endian + _PLY_TO_NP[kind[1]])
                scalars[pname][i] = np.frombuffer(body, npdt, 1, offset)[0]
                offset += npdt.itemsize
            else:
                cnt_dt = np.dtype(endian + _PLY_TO_NP[kind[1]])
                n_items = int(np.frombuffer(body, cnt_dt, 1, offset)[0])
                offset += cnt_dt.itemsize
                item_dt = np.dtype(endian + _PLY_TO_NP[kind[2]])
                vals = np.frombuffer(body, item_dt, n_items, offset)
                offset += item_dt.itemsize * n_items
                lists[pname][2].append(np.array(vals))
    return PlyElement(name, scalars, lists), offset


def _read_ascii(body: bytes, specs) -> list[PlyElement]:
    lines = body.decode("ascii").split("\n")
    li = 0
    out = []
    for name, count, props in specs:
        has_list = any(kind[0] == "list" for _, kind in props)
        scalar_props = [(p, k[1]) for p, k in props if k[0] == "scalar"]
        dt = np.dtype([(p, _PLY_TO_NP[t]) for p, t in scalar_props])
        arr = np.zeros(count, dtype=dt)
        lists: dict[str, tuple[str, str, list]] = {
            p: (k[1], k[2], []) for p, k in props if k[0] == "list"
        }
        for i in range(count):
            tokens = lines[li].split()
            li += 1
            t = 0
            for pname, kind in props:
                if kind[0] == "scalar":
                    arr[pname][i] = float(tokens[t])
                    t += 1
                else:
                    n_items = int(tokens[t])
                    t += 1
                    vals = [float(x) for x in tokens[t : t + n_items]]
                    t += n_items
                    lists[pname][2].append(
                        np.array(vals, dtype=_PLY_TO_NP[kind[2]])
                    )
        out.append(PlyElement(name, arr, lists))
    return out


def write(path: str, elements: list[PlyElement], comments: list[str] | None = None):
    """Write binary_little_endian PLY with the given elements in order.

    Writes to a same-directory temp file and ``os.replace``s into place:
    read clouds can be zero-copy views over an mmap of the SOURCE file
    (see ``read``), and truncating a file that is still mapped (an
    in-place ``-i x.ply -o x.ply`` conversion) would SIGBUS the encode
    pass mid-write.  The atomic swap keeps the old inode alive for the
    mapping and never exposes a half-written file.
    """
    import os
    import tempfile

    d = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".ply.tmp")
    os.close(fd)
    try:
        _write_to(tmp, elements, comments)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def _write_to(path: str, elements, comments):
    header = io.StringIO()
    header.write("ply\nformat binary_little_endian 1.0\n")
    for c in comments or []:
        header.write(f"comment {c}\n")
    for el in elements:
        header.write(f"element {el.name} {len(el.data)}\n")
        names = el.data.dtype.names or ()
        for pname in names:
            if pname == "_":
                continue
            header.write(f"property {_np_type_name(el.data.dtype[pname])} {pname}\n")
        for pname, (cnt_t, item_t, _) in el.list_props.items():
            header.write(f"property list {cnt_t} {item_t} {pname}\n")
    header.write("end_header\n")

    with open(path, "wb") as f:
        f.write(header.getvalue().encode("ascii"))
        for el in elements:
            if not el.list_props:
                le = el.data.astype(el.data.dtype.newbyteorder("<"), copy=False)
                if le.flags.c_contiguous:
                    f.write(le)  # zero-copy buffer write
                else:
                    f.write(le.tobytes())
            else:
                _write_rows_with_lists(f, el)


def _write_rows_with_lists(f, el: PlyElement):
    names = [n for n in (el.data.dtype.names or ()) if n != "_"]
    for i in range(len(el.data)):
        for pname in names:
            dt = np.dtype(el.data.dtype[pname]).newbyteorder("<")
            f.write(np.array(el.data[pname][i], dtype=dt).tobytes())
        for pname, (cnt_t, item_t, rows) in el.list_props.items():
            cnt_dt = np.dtype("<" + _PLY_TO_NP[cnt_t])
            item_dt = np.dtype("<" + _PLY_TO_NP[item_t])
            row = np.asarray(rows[i], dtype=item_dt)
            f.write(np.array(len(row), dtype=cnt_dt).tobytes())
            f.write(row.tobytes())


def sniff_header_text(path: str, nbytes: int = 2048) -> str:
    """First bytes of a file decoded as text, for format sniffing
    (reference converter.py:43-61)."""
    with open(path, "rb") as f:
        return f.read(nbytes).decode("utf-8", errors="ignore")


def header_elements(path: str) -> list[str]:
    """Element names from the header only (cheap --info scan,
    reference main.py:26-54)."""
    with open(path, "rb") as f:
        specs, _, _ = read_header(f)
    return [name for name, _, _ in specs]
