"""Molecular file formats in numpy, a copy of
``enflow_tpu/data/formats.py`` (the port imports nothing of the JAX
package): parsers, frame indexers, frame readers and writers for XYZ, GRO,
PDB, SDF and GROMACS TRR.

- XYZ / PDB / SDF are Angstrom by convention, GRO / TRR nm (velocities
  nm/ps). The parsers return the file's own units; ``readers.py`` scales
  them to the dataset's declared units.
- TRR is big-endian XDR: single or double precision (the width read from
  the frame header), the box, velocities and forces each optional. The
  port reads every TRR frame here; the JAX package also has a C++ reader
  of the same bytes (``enflow_tpu/native.py``), which the port does not
  need.
- The indexers (``index_xyz``, ``index_pdb``, ``index_trr``) scan a file
  once for its frames' byte offsets in O(1) memory, and the
  ``read_*_frame_at`` readers read one frame at an offset, so a trajectory
  streams one frame at a time (``readers.LargeMDDataset``).
"""

from __future__ import annotations

import struct

import numpy as np

# ---------------------------------------------------------------------------
# XYZ
# ---------------------------------------------------------------------------

def parse_xyz(path):
    """Yield ``(symbols, pos[N,3])`` per frame of a (multi-)XYZ file."""
    frames = []
    with open(path) as f:
        lines = f.read().split("\n")
    i = 0
    while i < len(lines):
        line = lines[i].strip()
        if not line:
            i += 1
            continue
        n = int(line)
        body = lines[i + 2:i + 2 + n]
        symbols, pos = [], []
        for row in body:
            parts = row.split()
            symbols.append(parts[0])
            pos.append([float(x) for x in parts[1:4]])
        frames.append((symbols, np.asarray(pos, np.float64)))
        i += 2 + n
    return frames


def index_xyz(path):
    """Byte-offset index of a (multi-)XYZ file: list of ``(offset, natoms)``
    per frame. O(1) memory — lines are scanned, never accumulated — so
    ``LargeMDDataset`` can stream arbitrarily long text trajectories at
    O(frame) RSS like the reference's per-access re-open pattern
    (reference ``enflow/data/md.py:7-23``)."""
    entries = []
    with open(path, "rb") as f:
        while True:
            off = f.tell()
            line = f.readline()
            if not line:
                break
            s = line.strip()
            if not s:
                continue
            n = int(s)
            for _ in range(n + 1):     # comment + atom lines
                f.readline()
            entries.append((off, n))
    return entries


def read_xyz_frame_at(path, offset):
    """``(symbols, pos[N,3])`` of ONE XYZ frame starting at byte ``offset``
    (from :func:`index_xyz`)."""
    with open(path, "rb") as f:
        f.seek(offset)
        n = int(f.readline().strip())
        f.readline()                   # comment
        symbols, pos = [], []
        for _ in range(n):
            parts = f.readline().split()
            symbols.append(parts[0].decode())
            pos.append([float(x) for x in parts[1:4]])
    return symbols, np.asarray(pos, np.float64)


def write_xyz(path, symbols, pos, comment=" "):
    with open(path, "w") as f:
        f.write(f"{len(symbols)}\n{comment}\n")
        for s, x in zip(symbols, np.asarray(pos)):
            f.write("%s %.18g %.18g %.18g\n" % (s, x[0], x[1], x[2]))


# ---------------------------------------------------------------------------
# GRO (GROMACS coordinate file; nm, nm/ps)
# ---------------------------------------------------------------------------

def parse_gro(path):
    """Parse a .gro file -> ``(names, pos[N,3], vel[N,3] | None, box[3])``."""
    with open(path) as f:
        lines = f.read().rstrip("\n").split("\n")
    n = int(lines[1].strip())
    names, pos, vel = [], [], []
    has_vel = len(lines[2]) >= 68
    for row in lines[2:2 + n]:
        names.append(row[10:15].strip())
        pos.append([float(row[20:28]), float(row[28:36]), float(row[36:44])])
        if has_vel:
            vel.append([float(row[44:52]), float(row[52:60]), float(row[60:68])])
    box = [float(x) for x in lines[2 + n].split()[:3]]
    return (names, np.asarray(pos, np.float64),
            np.asarray(vel, np.float64) if has_vel else None,
            np.asarray(box, np.float64))


# ---------------------------------------------------------------------------
# PDB (minimal: ATOM/HETATM/CRYST1/MODEL)
# ---------------------------------------------------------------------------

def parse_pdb(path):
    """Parse a PDB -> list of frames ``(symbols, pos[N,3], box[3] | None)``."""
    frames, symbols, pos, box = [], [], [], None
    with open(path) as f:
        for line in f:
            rec = line[:6].strip()
            if rec == "CRYST1":
                box = np.asarray([float(line[6:15]), float(line[15:24]),
                                  float(line[24:33])], np.float64)
            elif rec in ("ATOM", "HETATM"):
                elem = line[76:78].strip() or line[12:16].strip()[:1]
                symbols.append(elem.capitalize())
                pos.append([float(line[30:38]), float(line[38:46]),
                            float(line[46:54])])
            elif rec == "ENDMDL" and pos:
                frames.append((symbols, np.asarray(pos, np.float64), box))
                symbols, pos = [], []
    if pos:
        frames.append((symbols, np.asarray(pos, np.float64), box))
    return frames


def index_pdb(path):
    """Byte-offset index of a (multi-model) PDB: list of ``(offset, natoms)``
    per frame, where ``offset`` is the first ATOM/HETATM line of the frame
    and frames are delimited exactly as :func:`parse_pdb` delimits them
    (ENDMDL with accumulated atoms; trailing atoms form a final frame).
    O(1) memory (see :func:`index_xyz`)."""
    entries = []
    start, natoms = None, 0
    with open(path, "rb") as f:
        while True:
            off = f.tell()
            line = f.readline()
            if not line:
                break
            rec = line[:6].strip()
            if rec in (b"ATOM", b"HETATM"):
                if start is None:
                    start = off
                natoms += 1
            elif rec == b"ENDMDL" and natoms:
                entries.append((start, natoms))
                start, natoms = None, 0
    if natoms:
        entries.append((start, natoms))
    return entries


def read_pdb_frame_at(path, offset):
    """``(symbols, pos[N,3])`` of ONE PDB frame starting at byte ``offset``
    (from :func:`index_pdb`); reads until ENDMDL/EOF."""
    symbols, pos = [], []
    with open(path, "rb") as f:
        f.seek(offset)
        for raw in f:
            line = raw.decode("ascii", "replace")
            rec = line[:6].strip()
            if rec in ("ATOM", "HETATM"):
                elem = line[76:78].strip() or line[12:16].strip()[:1]
                symbols.append(elem.capitalize())
                pos.append([float(line[30:38]), float(line[38:46]),
                            float(line[46:54])])
            elif rec == "ENDMDL" and pos:
                break
    return symbols, np.asarray(pos, np.float64)


def write_pdb_model(fh, symbols, pos, box=None, model=1):
    """Append one MODEL block."""
    if box is not None:
        fh.write("CRYST1%9.3f%9.3f%9.3f  90.00  90.00  90.00 P 1           1\n"
                 % tuple(np.asarray(box)))
    fh.write(f"MODEL     {model:4d}\n")
    for i, (s, x) in enumerate(zip(symbols, np.asarray(pos)), start=1):
        fh.write("ATOM  %5d %-4s %-3s A%4d    %8.3f%8.3f%8.3f  1.00  0.00"
                 "          %2s\n" % (i % 100000, s[:4], s[:3].upper(), 1,
                                      x[0], x[1], x[2], s[:2]))
    fh.write("ENDMDL\n")


# ---------------------------------------------------------------------------
# SDF (MDL molfile V2000; Angstrom)
# ---------------------------------------------------------------------------

def parse_sdf(path):
    """Parse an SDF -> list of ``(name, symbols, pos[N,3])``.

    V2000 counts line + atom block only (bonds/properties skipped).
    """
    with open(path) as f:
        text = f.read()
    mols = []
    for block in text.split("$$$$"):
        lines = block.strip("\n").split("\n")
        if len(lines) < 4:
            continue
        name = lines[0].strip()
        counts = lines[3]
        try:
            natoms = int(counts[0:3])
        except ValueError:
            continue
        symbols, pos = [], []
        for row in lines[4:4 + natoms]:
            pos.append([float(row[0:10]), float(row[10:20]), float(row[20:30])])
            symbols.append(row[31:34].strip())
        mols.append((name, symbols, np.asarray(pos, np.float64)))
    return mols


# ---------------------------------------------------------------------------
# TRR (GROMACS binary trajectory; big-endian XDR; nm, nm/ps)
# ---------------------------------------------------------------------------

_TRR_MAGIC = 1993


def _read_xdr_string(f):
    (n,) = struct.unpack(">i", f.read(4))
    data = f.read(((n + 3) // 4) * 4)
    return data[:n].rstrip(b"\x00").decode()


def _read_trr_header(f, path):
    """Read one frame header at the current position.

    Returns ``(sizes dict, natoms, step, real_size)`` or None at clean EOF.
    """
    head = f.read(4)
    if len(head) < 4:
        return None
    (magic,) = struct.unpack(">i", head)
    if magic != _TRR_MAGIC:
        raise ValueError(f"bad TRR magic {magic} in {path}")
    _read_xdr_string(f)  # "GMX_trn_file"
    (ir_size, e_size, box_size, vir_size, pres_size, top_size,
     sym_size, x_size, v_size, f_size, natoms, step, nre) = \
        struct.unpack(">13i", f.read(52))
    # float width from whichever section is present
    if box_size:
        real_size = box_size // 9
    elif x_size:
        real_size = x_size // (3 * natoms)
    else:
        real_size = 4
    sizes = {"box": box_size, "vir": vir_size, "pres": pres_size,
             "x": x_size, "v": v_size, "f": f_size}
    return sizes, natoms, step, real_size


def _read_trr_frame(f, path):
    """Read one full frame at the current position; None at clean EOF."""
    hdr = _read_trr_header(f, path)
    if hdr is None:
        return None
    sizes, natoms, step, real_size = hdr
    rfmt = ">f" if real_size == 4 else ">d"

    def read_reals(count):
        return np.frombuffer(f.read(count * real_size),
                             dtype=np.dtype(rfmt)).astype(np.float64)

    t, lam = read_reals(2)
    box = read_reals(9).reshape(3, 3) if sizes["box"] else None
    if sizes["vir"]:
        read_reals(9)
    if sizes["pres"]:
        read_reals(9)
    x = read_reals(3 * natoms).reshape(natoms, 3) if sizes["x"] else None
    v = read_reals(3 * natoms).reshape(natoms, 3) if sizes["v"] else None
    frc = read_reals(3 * natoms).reshape(natoms, 3) if sizes["f"] else None
    return {"step": step, "time": float(t), "box": box,
            "pos": x, "vel": v, "force": frc}


def read_trr(path):
    """Parse a .trr trajectory.

    Returns a list of frame dicts with keys ``step``, ``time``, ``box [3,3]``,
    ``pos``, ``vel``, ``force`` (None when absent); nm / ps units.
    """
    frames = []
    with open(path, "rb") as f:
        while True:
            fr = _read_trr_frame(f, path)
            if fr is None:
                break
            frames.append(fr)
    return frames


def index_trr(path):
    """Frame-start byte offsets + first-frame atom count, in O(1) memory:
    headers are parsed, frame bodies are ``seek``'d over.
    """
    offsets, natoms = [], 0
    with open(path, "rb") as f:
        while True:
            off = f.tell()
            hdr = _read_trr_header(f, path)
            if hdr is None:
                break
            sizes, n, _, real_size = hdr
            if not offsets:
                natoms = n
            offsets.append(off)
            body = 2 + 9 * ((sizes["box"] > 0) + (sizes["vir"] > 0)
                            + (sizes["pres"] > 0))
            body += 3 * n * ((sizes["x"] > 0) + (sizes["v"] > 0)
                             + (sizes["f"] > 0))
            f.seek(body * real_size, 1)
    return np.asarray(offsets, np.int64), natoms


def read_trr_frame_at(path, offset):
    """Read one frame at a byte offset from :func:`index_trr`."""
    with open(path, "rb") as f:
        f.seek(int(offset))
        fr = _read_trr_frame(f, path)
    if fr is None:
        raise IOError(f"no TRR frame at offset {offset} in {path}")
    return fr


def write_trr(path, frames, double=False):
    """Write a .trr file (primarily for tests / interchange)."""
    real_size = 8 if double else 4
    rfmt = ">d" if double else ">f"
    with open(path, "wb") as f:
        for fr in frames:
            natoms = fr["pos"].shape[0]
            box = fr.get("box")
            vel = fr.get("vel")
            frc = fr.get("force")
            f.write(struct.pack(">i", _TRR_MAGIC))
            s = b"GMX_trn_file"
            f.write(struct.pack(">i", len(s) + 1))
            f.write(s + b"\x00" * (((len(s) + 4) // 4) * 4 - len(s)))
            sizes = [0, 0,
                     9 * real_size if box is not None else 0,
                     0, 0, 0, 0,
                     3 * natoms * real_size,
                     3 * natoms * real_size if vel is not None else 0,
                     3 * natoms * real_size if frc is not None else 0,
                     natoms, int(fr.get("step", 0)), 0]
            f.write(struct.pack(">13i", *sizes))
            f.write(struct.pack(rfmt[0] + rfmt[1] * 2,
                                float(fr.get("time", 0.0)), 0.0))
            if box is not None:
                f.write(np.asarray(box, np.float64).astype(rfmt).tobytes())
            for arr in (fr["pos"], vel, frc):
                if arr is not None:
                    f.write(np.asarray(arr, np.float64).astype(rfmt).tobytes())
