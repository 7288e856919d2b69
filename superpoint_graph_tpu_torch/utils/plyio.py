"""PLY I/O with numpy alone: ascii and binary_little_endian, any number of
elements, float/double/char/uchar/short/ushort/int/uint properties.

Port of superpoint_graph_tpu/utils/plyio.py: the same header, number
formats ("%d" for integers, "%.6g" for floats) and element order, so a
file written by either package is byte-identical for the same arrays and
reads in the other. Host code; no device.
"""
from __future__ import annotations

import numpy as np

_PLY_TO_NP = {
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
    "uchar": "u1", "uint8": "u1", "char": "i1", "int8": "i1",
    "short": "i2", "ushort": "u2", "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
}
_NP_TO_PLY = {"f4": "float", "f8": "double", "u1": "uchar", "i1": "char",
              "i2": "short", "u2": "ushort", "i4": "int", "u4": "uint"}


def _to_rec(arrays: dict):
    """(record array of the columns, [(name, numpy type code)])."""
    cols = {k: np.asarray(v) for k, v in arrays.items()}
    dtype = [(k, c.dtype.str.lstrip("<>|")) for k, c in cols.items()]
    rec = np.zeros(len(next(iter(cols.values()))), dtype=dtype)
    for k, c in cols.items():
        rec[k] = c
    return rec, dtype


def _ascii_lines(rec, dtype):
    """One text line a record: integers "%d", floats "%.6g", one space
    apart."""
    out = [np.char.mod("%d", rec[k]) if d.startswith(("u", "i"))
           else np.char.mod("%.6g", rec[k]) for k, d in dtype]
    lines = out[0]
    for c in out[1:]:
        lines = np.char.add(np.char.add(lines, " "), c)
    return lines


def write_ply_elements(filename: str, elements: dict, text: bool = True):
    """Write a multi-element ply, e.g. write_ply_elements(f, {"vertex":
    {"x": ...}, "edge": {"vertex1": ...}}); elements in dict order (the
    reference's spg2ply writes vertex then edge, provider.py:100-122)."""
    recs = {name: _to_rec(arrays) for name, arrays in elements.items()}
    header = ["ply", f"format {'ascii' if text else 'binary_little_endian'} "
              "1.0"]
    for name, (rec, dtype) in recs.items():
        header.append(f"element {name} {len(rec)}")
        header += [f"property {_NP_TO_PLY[d]} {k}" for k, d in dtype]
    header.append("end_header")
    with open(filename, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        for rec, dtype in recs.values():
            if not text:
                f.write(rec.tobytes())
                continue
            lines = _ascii_lines(rec, dtype)
            if len(lines):
                f.write(("\n".join(lines) + "\n").encode())


def write_ply(filename: str, arrays: dict, text: bool = True):
    """Write named per-vertex properties, e.g. write_ply(f, {"x": ...,
    "y": ..., "z": ..., "red": ...})."""
    write_ply_elements(filename, {"vertex": arrays}, text=text)


def read_ply_elements(filename: str) -> dict:
    """Every element of a ply file: {element: {property: array}}."""
    with open(filename, "rb") as f:
        if f.readline().decode().strip() != "ply":
            raise ValueError(f"{filename} is not a ply file")
        fmt = None
        order = []  # (name, count, [(property, numpy type code)])
        while True:
            line = f.readline().decode().strip()
            if line.startswith("format"):
                fmt = line.split()[1]
            elif line.startswith("element"):
                _, name, cnt = line.split()
                order.append((name, int(cnt), []))
            elif line.startswith("property"):
                _, t, pname = line.split()
                order[-1][2].append((pname, _PLY_TO_NP[t]))
            elif line == "end_header":
                break
        result = {}
        if fmt == "ascii":
            lines = f.read().decode().splitlines()
            row = 0
            for name, n, props in order:
                rec = np.zeros(n, dtype=np.dtype(props))
                if n:
                    data = np.loadtxt(lines[row:row + n], dtype=np.float64,
                                      ndmin=2)
                    for i, (pname, _) in enumerate(props):
                        rec[pname] = data[:, i]
                row += n
                result[name] = {p: np.array(rec[p]) for p, _ in props}
        else:
            for name, n, props in order:
                dtype = np.dtype(props)
                rec = np.frombuffer(f.read(n * dtype.itemsize), dtype=dtype)
                result[name] = {p: np.array(rec[p]) for p, _ in props}
        return result


def read_ply(filename: str) -> dict:
    """The vertex properties of a ply file: {property: array}."""
    return read_ply_elements(filename)["vertex"]
