"""Trajectory and structure dataset readers, the port of
``enflow_tpu/data/readers.py``: host-side numpy code over ``formats.py``
whose samples reach the driver's device through ``pad_samples``.

- ``sdf``: MDL SDF molecules (label = the molecule's name).
- ``hdf5``: h5py nested groups of species, coordinates and a diagonal
  cell; ``h5py`` is imported when the dataset is processed.
- ``md``: (topology, trajectory) pairs in memory. MDAnalysis when it
  imports (positions in Angstrom), else the native ``.gro``/``.pdb``/
  ``.xyz`` topologies and ``.trr``/``.xyz``/``.pdb``/``.gro``
  trajectories.
- ``largemd``: the same frames read one at a time. ``.trr``, ``.xyz`` and
  ``.pdb`` trajectories stream from a frame-offset index (``max_atoms``
  from the index); a ``.gro`` is parsed whole.
- ``trr``: GROMACS TRR frames read one at a time (nm / ps, box per frame).
- ``xyz``: multi-frame XYZ files.

Distances are scaled from each file's own unit (nm for ``.trr``/``.gro``,
Angstrom otherwise) to the declared ``dist_unit``, velocities also from ps
to the declared ``time_unit``; a list of mixed files takes each file's own
scale. The transforms then take the declared units to reduced units.
"""

from __future__ import annotations

import numpy as np

from ..utils.conversion import _DIST_UNITS, _TIME_UNITS
from ..utils.helpers import get_element
from . import formats
from .datasets import BaseDataset, InMemoryDataset, register_dataset


def _dist_scale(file_unit, declared_unit):
    """Multiplier taking file-native distances to the declared lab unit."""
    return _DIST_UNITS[file_unit] / _DIST_UNITS[declared_unit]


def _vel_scale(file_dist, file_time, declared_dist, declared_time):
    return (_DIST_UNITS[file_dist] / _DIST_UNITS[declared_dist]) / (
        _TIME_UNITS[file_time] / _TIME_UNITS[declared_time])


def _listify(x):
    return x if isinstance(x, (list, tuple)) else [x]


@register_dataset("sdf")
class SDFDataset(InMemoryDataset):
    """MDL SDF reader (label = molecule name)."""

    def process(self, raw_file, dist_unit="ang", time_unit="pico",
                file_dist_unit="ang", **_):
        scale = _dist_scale(file_dist_unit, dist_unit)
        for path in _listify(raw_file):
            for name, symbols, pos in formats.parse_sdf(path):
                self.append(z=symbols, pos=pos * scale, label=name)


@register_dataset("hdf5")
class HDF5Dataset(InMemoryDataset):
    """h5py nested-group reader: species, first-frame coordinates and the
    diagonal of the cell, in ``file_dist_unit``."""

    def process(self, raw_file, dist_unit="ang", time_unit="pico",
                file_dist_unit="ang", **_):
        import h5py
        scale = _dist_scale(file_dist_unit, dist_unit)
        for path in _listify(raw_file):
            with h5py.File(path, "r") as f:
                for i in f.keys():
                    for j in f[i].keys():
                        dct = f[i][j]
                        z = [s.decode("utf-8") if isinstance(s, bytes)
                             else str(s) for s in dct["species"]]
                        cell = np.asarray(dct["cell"])
                        box = np.array([cell[0, 0, 0], cell[0, 1, 1],
                                        cell[0, 2, 2]]) * scale
                        self.append(
                            z=z,
                            pos=np.asarray(dct["coordinates"])[0] * scale,
                            box=box, label="hdf5")


def _mdanalysis_or_none():
    try:
        import MDAnalysis
        return MDAnalysis
    except ImportError:
        return None


@register_dataset("md")
class MDDataset(InMemoryDataset):
    """In-memory trajectory reader over (top_file, traj_file) pairs."""

    def process(self, top_file, traj_file, dist_unit="ang", time_unit="pico",
                **_):
        mda = _mdanalysis_or_none()
        for top, traj in zip(_listify(top_file), _listify(traj_file)):
            if mda is not None:
                u = mda.Universe(top, traj)
                dscale = _dist_scale("ang", dist_unit)   # MDAnalysis: Å
                vscale = _vel_scale("ang", "pico", dist_unit, time_unit)
                for frame, ts in enumerate(u.trajectory):
                    z = [get_element(getattr(a, "element", ""), a.mass)
                         for a in u.atoms]
                    vel = (u.atoms.velocities * vscale
                           if ts.has_velocities else None)
                    self.append(z=z, pos=u.atoms.positions * dscale, vel=vel,
                                label=f"{traj} frame: {frame}")
            else:
                self._process_native(top, traj, dist_unit, time_unit)

    def _process_native(self, top, traj, dist_unit, time_unit):
        names, _, _, _ = _parse_topology(top)
        z = [_element_from_name(n) for n in names]
        file_d, file_t = _traj_units(traj)
        dscale = _dist_scale(file_d, dist_unit)
        vscale = _vel_scale(file_d, file_t, dist_unit, time_unit)
        for frame, (pos, vel) in enumerate(_iter_traj(traj)):
            self.append(z=z, pos=pos * dscale,
                        vel=None if vel is None else vel * vscale,
                        label=f"{traj} frame: {frame}")


def _symbols_from(ds, natoms, default):
    """Atom symbols from the dataset's ``top_file`` (cached), else
    ``natoms`` copies of ``default``."""
    top = ds.input_params.get("top_file")
    if not top:
        return [default] * natoms
    if not hasattr(ds, "_symbol_cache"):
        names, _, _, _ = _parse_topology(top)
        ds._symbol_cache = [_element_from_name(n) for n in names]
    return ds._symbol_cache


@register_dataset("largemd")
class LargeMDDataset(BaseDataset):
    """Per-index trajectory reader: a Sample is built at each access.
    ``.trr``, ``.xyz`` and ``.pdb`` trajectories stream (only the frame
    index stays resident); a ``.gro`` is parsed whole and cached."""

    _STREAM_EXTS = (".trr", ".xyz", ".pdb")

    def _frames(self):
        if not hasattr(self, "_frame_cache"):
            # each frame keeps its file: unit scales are per file
            self._frame_cache = [
                (path, pos, vel)
                for path in _listify(self.input_params["traj_file"])
                for pos, vel in _iter_traj(path)]
        return self._frame_cache

    def _is_streaming(self):
        paths = _listify(self.input_params["traj_file"])
        return all(p.endswith(self._STREAM_EXTS) for p in paths)

    def _frame_at(self, idx):
        """``(path, pos, vel)`` of one frame."""
        if self._is_streaming():
            path, offset, _ = _stream_entries(self)[idx]
            if path.endswith(".trr"):
                fr = formats.read_trr_frame_at(path, offset)
                return path, fr["pos"], fr["vel"]
            if path.endswith(".xyz"):
                _, pos = formats.read_xyz_frame_at(path, offset)
            else:
                _, pos = formats.read_pdb_frame_at(path, offset)
            return path, pos, None
        return self._frames()[idx]

    def __len__(self):
        if self._is_streaming():
            return len(_stream_entries(self))
        return len(self._frames())

    @property
    def max_atoms(self) -> int:
        # a streaming index knows every frame's atom count
        if self._is_streaming():
            return max(natoms for _, _, natoms in _stream_entries(self))
        return super().max_atoms

    def __getitem__(self, idx):
        dist_unit = self.input_params.get("dist_unit", "ang")
        time_unit = self.input_params.get("time_unit", "pico")
        path, pos, vel = self._frame_at(idx)
        file_d, file_t = _traj_units(path)
        z = _symbols_from(self, pos.shape[0], "C")
        return self._get_sample(
            z, pos * _dist_scale(file_d, dist_unit),
            None if vel is None else
            vel * _vel_scale(file_d, file_t, dist_unit, time_unit),
            label=f"Frame: {idx}")


def _stream_entries(ds):
    """The streaming index of ``ds``'s trajectory files, built once:
    ``(path, byte_offset, natoms)`` a frame."""
    if not hasattr(ds, "_stream_index_cache"):
        entries = []
        for path in _listify(ds.input_params["traj_file"]):
            if path.endswith(".xyz"):
                entries += [(path, int(o), int(n))
                            for o, n in formats.index_xyz(path)]
            elif path.endswith(".pdb"):
                entries += [(path, int(o), int(n))
                            for o, n in formats.index_pdb(path)]
            else:
                offsets, natoms = formats.index_trr(path)
                entries += [(path, int(o), int(natoms)) for o in offsets]
        ds._stream_index_cache = entries
    return ds._stream_index_cache


@register_dataset("trr")
class TRRDataset(BaseDataset):
    """GROMACS TRR frames read one at a time from the frame-offset index.
    ``top_file`` (``.gro``/``.pdb``/``.xyz``) names the atoms; without it
    every atom is argon."""

    def __len__(self):
        return len(_stream_entries(self))

    @property
    def max_atoms(self) -> int:
        return max(natoms for _, _, natoms in _stream_entries(self))

    def __getitem__(self, idx):
        dist_unit = self.input_params.get("dist_unit", "ang")
        time_unit = self.input_params.get("time_unit", "pico")
        path, offset, _ = _stream_entries(self)[idx]
        fr = formats.read_trr_frame_at(path, offset)
        pos = fr["pos"]
        dscale = _dist_scale("nm", dist_unit)
        vscale = _vel_scale("nm", "pico", dist_unit, time_unit)
        box = (np.diag(fr["box"]) * dscale) if fr["box"] is not None else None
        return self._get_sample(
            _symbols_from(self, pos.shape[0], "Ar"), pos * dscale,
            None if fr["vel"] is None else fr["vel"] * vscale,
            box=box, label=f"Frame: {idx}")


@register_dataset("xyz")
class XYZDataset(InMemoryDataset):
    """Multi-frame XYZ reader (Angstrom unless ``file_dist_unit``)."""

    def process(self, raw_file, dist_unit="ang", time_unit="pico",
                file_dist_unit="ang", **_):
        scale = _dist_scale(file_dist_unit, dist_unit)
        for path in _listify(raw_file):
            for frame, (symbols, pos) in enumerate(formats.parse_xyz(path)):
                self.append(z=symbols, pos=pos * scale,
                            label=f"{path} frame: {frame}")


# ---------------------------------------------------------------------------
# topology and trajectory helpers
# ---------------------------------------------------------------------------

_ELEMENT_SYMBOLS = {"H", "C", "N", "O", "F", "P", "S", "K", "B", "Cl", "Na",
                    "Mg", "Ar", "He", "Ne", "Li", "Be", "Al", "Si"}
_TWO_LETTER = ("Cl", "Na", "Mg", "Ar", "He", "Ne", "Li", "Be", "Al", "Si")


def _element_from_name(name):
    """Guess an element from an atom name like 'CA', 'HW1', 'OW'."""
    name = name.strip()
    two = name[:2].capitalize()
    if two in _ELEMENT_SYMBOLS and not name[:1].isdigit() \
            and two in _TWO_LETTER:
        return two
    for ch in name:
        if ch.isalpha():
            return ch.upper()
    raise ValueError(f"cannot guess element from atom name {name!r}")


def _parse_topology(path):
    if path.endswith(".gro"):
        return formats.parse_gro(path)
    if path.endswith(".pdb"):
        symbols, pos, box = formats.parse_pdb(path)[0]
        return symbols, pos, None, box
    if path.endswith(".xyz"):
        symbols, pos = formats.parse_xyz(path)[0]
        return symbols, pos, None, None
    raise ValueError(f"unsupported topology format: {path}")


def _traj_units(path):
    """(dist, time) native units of a trajectory file."""
    if path.endswith((".trr", ".gro")):
        return "nm", "pico"
    return "ang", "pico"


def _iter_traj(path):
    if path.endswith(".trr"):
        return [(fr["pos"], fr["vel"]) for fr in formats.read_trr(path)]
    if path.endswith(".xyz"):
        return [(pos, None) for _, pos in formats.parse_xyz(path)]
    if path.endswith(".pdb"):
        return [(pos, None) for _, pos, _ in formats.parse_pdb(path)]
    if path.endswith(".gro"):
        _, pos, vel, _ = formats.parse_gro(path)
        return [(pos, vel)]
    raise ValueError(f"unsupported trajectory format: {path}")
