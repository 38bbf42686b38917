"""Point-cloud file IO without open3d.

Covers the reference's formats (``dataset/dataset.py:43-108``): ``.bin``
(KITTI float32 Nx4), ``.txt``, ``.npy``/``.npz``, ``.ply`` (ascii + binary
little-endian) and ``.pcd`` (ascii + binary).
"""

from __future__ import annotations

import struct

import numpy as np


def load_point_cloud(file: str) -> np.ndarray:
    """Load an (N, 3) float point cloud from any supported format."""
    ext = file.split(".")[-1].lower()
    if ext == "txt":
        pc = np.loadtxt(file)
    elif ext == "bin":
        pc = np.fromfile(file, dtype=np.float32).reshape(-1, 4)
    elif ext in ("npy", "npz"):
        pc = np.load(file)
        if isinstance(pc, np.lib.npyio.NpzFile):
            pc = pc[pc.files[0]]
    elif ext == "ply":
        pc = _read_ply(file)
    elif ext == "pcd":
        pc = _read_pcd(file)
    else:
        raise AssertionError("File type not correct: " + file)
    return np.asarray(pc, dtype=np.float64)[:, :3]


def load_point_cloud_f32(file: str) -> np.ndarray:
    """Throughput-path loader: (N, >=3) float32, minimal copies.

    ``load_point_cloud`` round-trips through float64 for reference parity
    (dataset/dataset.py:43-63 feeds float64 into o3d); on the datalist hot
    path that conversion is pure overhead.  KITTI .bin
    files are already float32 (N, 4) on disk — return them as-is (columns
    beyond xyz are ignored downstream via the stride argument; an mmap
    variant was A/B-measured no faster than the page-cache memcpy)."""
    if file.split(".")[-1].lower() == "bin":
        return np.fromfile(file, dtype=np.float32).reshape(-1, 4)
    return np.ascontiguousarray(load_point_cloud(file), dtype=np.float32)


def save_point_cloud(file: str, point_cloud: np.ndarray) -> None:
    """Save, dropping points whose coordinates SUM to zero — deliberate
    reference parity (dataset.py:74-75, same rule in decode.cpp's compacted
    output): decoded zero pixels land exactly at the origin and are
    dropped, but a legitimate point on the x+y+z=0 plane (e.g. (1,-1,0))
    is also removed.  Keep this in mind when comparing clouds point-for-
    point; the codec's own eval paths compare range images, not saves."""
    pc = np.asarray(point_cloud).reshape(-1, point_cloud.shape[-1])
    pc = pc[np.sum(pc, -1) != 0]
    ext = file.split(".")[-1].lower()
    if ext == "txt":
        np.savetxt(file, np.concatenate([pc, np.zeros((pc.shape[0], 1))], -1))
    elif ext == "bin":
        np.concatenate([pc, np.zeros((pc.shape[0], 1))], -1).astype(np.float32).tofile(file)
    elif ext in ("npy", "npz"):
        np.save(file, np.concatenate([pc, np.zeros((pc.shape[0], 1))], -1))
    elif ext == "ply":
        _write_ply(file, pc[:, :3])
    elif ext == "pcd":
        _write_pcd(file, pc[:, :3])
    else:
        raise AssertionError("File type not correct.")


# ------------------------------------------------------------------- PLY
def _write_ply(file: str, pc: np.ndarray) -> None:
    with open(file, "wb") as f:
        f.write(b"ply\n")
        f.write(b"format binary_little_endian 1.0\n")
        f.write(b"element vertex %d\n" % pc.shape[0])
        f.write(b"property float x\nproperty float y\nproperty float z\n")
        f.write(b"end_header\n")
        f.write(np.ascontiguousarray(pc, dtype="<f4").tobytes())


def _read_ply(file: str) -> np.ndarray:
    with open(file, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError("not a ply file")
        fmt = None
        n = 0
        props = []
        while True:
            raw_line = f.readline()
            if not raw_line:  # EOF before end_header: truncated/corrupt file
                raise ValueError(f"truncated ply header in {file}")
            line = raw_line.strip()
            if line.startswith(b"format"):
                fmt = line.split()[1]
            elif line.startswith(b"element vertex"):
                n = int(line.split()[-1])
            elif line.startswith(b"element"):
                raise ValueError("only vertex-only ply supported")
            elif line.startswith(b"property"):
                props.append((line.split()[1].decode(), line.split()[2].decode()))
            elif line == b"end_header":
                break
        typemap = {"float": "<f4", "float32": "<f4", "double": "<f8", "float64": "<f8",
                   "uchar": "u1", "uint8": "u1", "int": "<i4", "int32": "<i4"}
        if fmt == b"ascii":
            data = np.loadtxt(f, max_rows=n).reshape(n, -1)
            return data[:, :3]
        dtype = np.dtype([(name, typemap[t]) for t, name in props])
        raw = np.frombuffer(f.read(n * dtype.itemsize), dtype=dtype)
        return np.stack([raw["x"], raw["y"], raw["z"]], -1)


# ------------------------------------------------------------------- PCD
def _write_pcd(file: str, pc: np.ndarray) -> None:
    n = pc.shape[0]
    header = (
        "# .PCD v0.7 - Point Cloud Data file format\n"
        "VERSION 0.7\nFIELDS x y z\nSIZE 4 4 4\nTYPE F F F\nCOUNT 1 1 1\n"
        f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS {n}\n"
        "DATA binary\n"
    )
    with open(file, "wb") as f:
        f.write(header.encode())
        f.write(np.ascontiguousarray(pc, dtype="<f4").tobytes())


def _read_pcd(file: str) -> np.ndarray:
    with open(file, "rb") as f:
        fields, sizes, types, counts = [], [], [], []
        n = 0
        data_mode = "ascii"
        while True:
            raw_line = f.readline()
            if not raw_line:  # EOF before DATA: truncated/corrupt file
                raise ValueError(f"truncated pcd header in {file}")
            line = raw_line.decode("ascii", "ignore").strip()
            key, _, rest = line.partition(" ")
            if key == "FIELDS":
                fields = rest.split()
            elif key == "SIZE":
                sizes = [int(s) for s in rest.split()]
            elif key == "TYPE":
                types = rest.split()
            elif key == "COUNT":
                counts = [int(c) for c in rest.split()]
            elif key == "POINTS":
                n = int(rest)
            elif key == "DATA":
                data_mode = rest.strip()
                break
        tmap = {("F", 4): "<f4", ("F", 8): "<f8", ("U", 1): "u1", ("U", 2): "<u2",
                ("U", 4): "<u4", ("I", 1): "i1", ("I", 2): "<i2", ("I", 4): "<i4"}
        if not counts:
            counts = [1] * len(fields)
        if data_mode == "ascii":
            data = np.loadtxt(f, max_rows=n).reshape(n, -1)
            cols = {name: data[:, i] for i, name in enumerate(fields)}
        else:
            dtype = np.dtype(
                [
                    (name, tmap[(t, s)], (c,)) if c > 1 else (name, tmap[(t, s)])
                    for name, s, t, c in zip(fields, sizes, types, counts)
                ]
            )
            raw = np.frombuffer(f.read(n * dtype.itemsize), dtype=dtype)
            cols = {name: raw[name] for name in fields}
        return np.stack([cols["x"], cols["y"], cols["z"]], -1).astype(np.float64)


def write_ply_struct(file: str, pc: np.ndarray) -> None:
    """struct-per-point writer kept for byte parity with dataset.py:85-99."""
    with open(file, "wb") as f:
        f.write(bytes("ply\n", "utf-8"))
        f.write(bytes("format binary_little_endian 1.0\n", "utf-8"))
        f.write(bytes("element vertex %d\n" % pc.shape[0], "utf-8"))
        f.write(bytes("property float x\n", "utf-8"))
        f.write(bytes("property float y\n", "utf-8"))
        f.write(bytes("property float z\n", "utf-8"))
        f.write(bytes("end_header\n", "utf-8"))
        for i in range(pc.shape[0]):
            f.write(bytearray(struct.pack("fff", pc[i, 0], pc[i, 1], pc[i, 2])))
