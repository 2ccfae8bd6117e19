"""Port parity: the file formats, the dataset readers, ``compose`` and the
rest of ``utils/helpers.py`` against the JAX package.

Files are written by the test from numpy-seeded data; the same files go
through ``enflow_tpu.data`` and ``enflow_tpu_torch.data``. Integers, text
and the written bytes must be equal; floats within 1e-12 (the parsers are
the same numpy code, so in practice equal).
"""

import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enflow_tpu.data import datasets as j_datasets
from enflow_tpu.data import formats as j_formats
from enflow_tpu.data import readers as j_readers
from enflow_tpu.data import transforms as j_transforms
from enflow_tpu.utils import helpers as j_helpers

from enflow_tpu_torch.data import datasets, formats, readers, transforms
from enflow_tpu_torch.utils import helpers

TOL = 1e-12


def _eq(a, b):
    """Equal nested results: text and integers exactly, floats to TOL."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _eq(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _eq(x, y)
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        if a is None or b is None:
            assert a is None and b is None
            return
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype
        if np.issubdtype(a.dtype, np.floating):
            np.testing.assert_allclose(a, b, rtol=0, atol=TOL)
        else:
            np.testing.assert_array_equal(a, b)
    else:
        assert a == b


# ---------------------------------------------------------------------------
# files
# ---------------------------------------------------------------------------

def write_gro(path, names, pos, vel=None, box=(3.0, 3.0, 3.0)):
    with open(path, "w") as f:
        f.write(f"test\n{len(names):5d}\n")
        for i, (n, p) in enumerate(zip(names, pos), start=1):
            line = "%5d%-5s%5s%5d%8.3f%8.3f%8.3f" % (1, "MOL", n, i, *p)
            if vel is not None:
                line += "%8.4f%8.4f%8.4f" % tuple(vel[i - 1])
            f.write(line + "\n")
        f.write("%10.5f%10.5f%10.5f\n" % tuple(box))


def write_sdf(path, rng, n_mols=3):
    with open(path, "w") as f:
        for m in range(n_mols):
            syms = ["O", "H", "H", "C"][:2 + m % 3]
            f.write(f"mol{m}\n  prog\n comment\n"
                    f"{len(syms):3d}  0  0  0  0  0  0  0  0  0999 V2000\n")
            for s, p in zip(syms, rng.normal(size=(len(syms), 3))):
                f.write("%10.4f%10.4f%10.4f %-3s 0  0\n" % (*p, s))
            f.write("M  END\n$$$$\n")


def trr_frames(rng, n_frames=3, n_atoms=5, box=True, vel=True, force=False):
    return [{"step": 10 * i, "time": 0.02 * i,
             "box": np.diag([3.0, 3.1, 3.2]) if box else None,
             "pos": rng.normal(size=(n_atoms, 3)),
             "vel": rng.normal(size=(n_atoms, 3)) if vel else None,
             "force": rng.normal(size=(n_atoms, 3)) if force else None}
            for i in range(n_frames)]


def write_xyz_traj(path, rng, n_frames=3, syms=("C", "O", "C", "N")):
    with open(path, "w") as f:
        for i in range(n_frames):
            pos = rng.normal(size=(len(syms), 3)) * 2
            f.write(f"{len(syms)}\nframe {i}\n")
            for s, p in zip(syms, pos):
                f.write("%s %.10f %.10f %.10f\n" % (s, *p))


def write_pdb_traj(path, rng, n_frames=3, syms=("C", "O", "C", "N")):
    with open(path, "w") as fh:
        for m in range(n_frames):
            j_formats.write_pdb_model(fh, list(syms),
                                      rng.normal(size=(len(syms), 3)) * 2,
                                      box=[20.0, 20.0, 20.0], model=m + 1)


@pytest.mark.parametrize("kind", ["single", "double", "no_vel", "no_box",
                                  "force"])
def test_trr_parse_index_and_write_match_jax(tmp_path, kind):
    rng = np.random.default_rng(len(kind))
    fr = trr_frames(rng, vel=kind != "no_vel", box=kind != "no_box",
                    force=kind == "force")
    double = kind != "single"
    jp, tp = str(tmp_path / "j.trr"), str(tmp_path / "t.trr")
    j_formats.write_trr(jp, fr, double=double)
    formats.write_trr(tp, fr, double=double)
    assert open(jp, "rb").read() == open(tp, "rb").read()
    _eq(j_formats.read_trr(jp), formats.read_trr(tp))
    (jo, jn), (to, tn) = j_formats.index_trr(jp), formats.index_trr(tp)
    _eq(jo, to)
    assert jn == tn == 5
    for off in to:
        _eq(j_formats.read_trr_frame_at(jp, off),
            formats.read_trr_frame_at(tp, off))
    with pytest.raises(IOError):
        formats.read_trr_frame_at(tp, len(open(tp, "rb").read()))


def test_text_formats_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    xyz = str(tmp_path / "a.xyz")
    write_xyz_traj(xyz, rng)
    _eq(j_formats.parse_xyz(xyz), formats.parse_xyz(xyz))
    _eq(j_formats.index_xyz(xyz), formats.index_xyz(xyz))
    for off, _ in formats.index_xyz(xyz):
        _eq(j_formats.read_xyz_frame_at(xyz, off),
            formats.read_xyz_frame_at(xyz, off))
    pdb = str(tmp_path / "a.pdb")
    write_pdb_traj(pdb, rng)
    _eq(j_formats.parse_pdb(pdb), formats.parse_pdb(pdb))
    _eq(j_formats.index_pdb(pdb), formats.index_pdb(pdb))
    for off, _ in formats.index_pdb(pdb):
        _eq(j_formats.read_pdb_frame_at(pdb, off),
            formats.read_pdb_frame_at(pdb, off))
    for vel in (None, rng.normal(size=(4, 3))):
        gro = str(tmp_path / "a.gro")
        write_gro(gro, ["OW", "HW1", "HW2", "Cl"], rng.normal(size=(4, 3)),
                  vel)
        _eq(j_formats.parse_gro(gro), formats.parse_gro(gro))
    sdf = str(tmp_path / "a.sdf")
    write_sdf(sdf, rng)
    _eq(j_formats.parse_sdf(sdf), formats.parse_sdf(sdf))
    # the writers give the JAX package's bytes
    syms, pos = ["Ar", "C"], rng.normal(size=(2, 3))
    j_formats.write_xyz(str(tmp_path / "j.xyz"), syms, pos, comment="c")
    formats.write_xyz(str(tmp_path / "t.xyz"), syms, pos, comment="c")
    with open(tmp_path / "j.pdb", "w") as a, open(tmp_path / "t.pdb",
                                                  "w") as b:
        j_formats.write_pdb_model(a, syms, pos, box=[9.0, 9.0, 9.0], model=3)
        formats.write_pdb_model(b, syms, pos, box=[9.0, 9.0, 9.0], model=3)
    for ext in ("xyz", "pdb"):
        assert (tmp_path / f"j.{ext}").read_bytes() == \
            (tmp_path / f"t.{ext}").read_bytes()


# ---------------------------------------------------------------------------
# readers
# ---------------------------------------------------------------------------

def _tf(mod):
    """The driver's transforms of either package (ang, pico)."""
    return mod.Compose([mod.ConvertPositionsFrom("ang"), mod.Center(),
                        mod.ConvertVelocitiesFrom("ang", "pico")])


def _pair(cls_name, transform=True, **params):
    """The same dataset type built by both packages from ``params``."""
    j = j_datasets.get_dataset_class(cls_name)
    t = datasets.get_dataset_class(cls_name)
    jkw = dict(params, seed=5)
    tkw = dict(params, seed=5, device="cpu")
    if transform:
        jkw["transform"] = _tf(j_transforms)
        tkw["transform"] = _tf(transforms)
    return j(**jkw), t(**tkw)


def _same_samples(jd, td, n=None):
    assert len(jd) == len(td) and jd.max_atoms == td.max_atoms
    assert jd.node_nf == td.node_nf
    for i in range(n or len(td)):
        a, b = jd[i], td[i]
        assert a.z == b.z and a.label == b.label and a.r_cut == b.r_cut
        for f in ("h", "g", "pos", "vel", "box"):
            np.testing.assert_allclose(getattr(b, f), getattr(a, f),
                                       rtol=0, atol=TOL)


def _files(tmp_path, seed=0):
    rng = np.random.default_rng(seed)
    trr = str(tmp_path / "t.trr")
    formats.write_trr(trr, trr_frames(rng, n_atoms=4), double=True)
    trr32 = str(tmp_path / "s.trr")
    formats.write_trr(trr32, trr_frames(rng, n_atoms=4, vel=False,
                                        box=False), double=False)
    xyz = str(tmp_path / "t.xyz")
    write_xyz_traj(xyz, rng)
    pdb = str(tmp_path / "t.pdb")
    write_pdb_traj(pdb, rng)
    gro = str(tmp_path / "t.gro")
    write_gro(gro, ["C1", "OW", "C2", "N"], rng.normal(size=(4, 3)),
              rng.normal(size=(4, 3)))
    sdf = str(tmp_path / "m.sdf")
    write_sdf(sdf, rng)
    return dict(trr=trr, trr32=trr32, xyz=xyz, pdb=pdb, gro=gro, sdf=sdf)


BASE = dict(r_cut=3.0, box=[30.0, 30.0, 30.0], dist_unit="ang",
            time_unit="pico")


@pytest.mark.parametrize("case", [
    "md_gro_trr", "md_xyz_trr32", "md_pdb_xyz", "md_gro_pdb", "md_gro_gro",
    "md_list", "largemd_trr", "largemd_xyz", "largemd_pdb", "largemd_gro",
    "largemd_mixed", "trr_top", "trr_bare", "xyz", "sdf"])
def test_readers_match_jax(tmp_path, case):
    f = _files(tmp_path)
    kind = case.split("_")[0]
    if case == "md_list":
        params = dict(top_file=[f["gro"], f["xyz"]],
                      traj_file=[f["trr"], f["pdb"]])
    elif kind == "md":
        top, traj = case.split("_")[1:]
        traj = "trr32" if traj == "trr32" else traj
        params = dict(top_file=f[top], traj_file=f[traj])
    elif kind == "largemd":
        src = case.split("_")[1]
        params = dict(top_file=f["gro"])
        params["traj_file"] = ([f["trr"], f["xyz"], f["pdb"]]
                               if src == "mixed" else f[src])
    elif case == "trr_top":
        params = dict(top_file=f["gro"], traj_file=f["trr"])
    elif case == "trr_bare":
        params = dict(traj_file=f["trr32"], atom_types=["Ar"])
    else:
        params = dict(raw_file=f[kind])
    atom_types = params.pop("atom_types", ["H", "C", "N", "O"])
    jd, td = _pair(kind, **BASE, **params, atom_types=atom_types)
    _same_samples(jd, td)


def test_hdf5_reader_matches_jax(tmp_path):
    h5py = pytest.importorskip("h5py")
    path = str(tmp_path / "a.h5")
    rng = np.random.default_rng(3)
    with h5py.File(path, "w") as f:
        for g in ("g1", "g2"):
            grp = f.create_group(g).create_group("mol1")
            grp["species"] = np.array([b"C", b"O", b"H"])
            grp["coordinates"] = rng.normal(size=(2, 3, 3))
            grp["cell"] = np.tile(np.eye(3) * 9.0, (2, 1, 1))
    jd, td = _pair("hdf5", raw_file=path, r_cut=3.0, file_dist_unit="nm",
                   dist_unit="ang")
    _same_samples(jd, td)
    np.testing.assert_allclose(td[0].box, 90.0 / 3.4)    # 9 nm in sigma


def test_largemd_streams_what_md_reads(tmp_path):
    """The streamed frames (index + one frame a read) equal the in-memory
    reader's, and the non-streaming path (a .gro in the list) the
    streamed one's."""
    f = _files(tmp_path, seed=1)
    kw = dict(BASE, atom_types=["H", "C", "N", "O"], seed=9, device="cpu")
    for traj in ("trr", "xyz", "pdb"):
        md = readers.MDDataset(top_file=f["gro"], traj_file=f[traj], **kw)
        lg = readers.LargeMDDataset(top_file=f["gro"], traj_file=f[traj],
                                    **kw)
        assert lg._is_streaming() and not hasattr(lg, "_frame_cache")
        assert len(lg) == len(md) and lg.max_atoms == md.max_atoms == 4
        for i in range(len(md)):
            a, b = md[i], lg[i]
            assert a.z == b.z
            for fld in ("h", "g", "pos", "vel", "box"):
                np.testing.assert_array_equal(getattr(a, fld),
                                              getattr(b, fld))
        assert not hasattr(lg, "_frame_cache")
    whole = readers.LargeMDDataset(top_file=f["gro"],
                                   traj_file=[f["trr"], f["gro"]], **kw)
    assert not whole._is_streaming()
    streamed = readers.LargeMDDataset(top_file=f["gro"], traj_file=f["trr"],
                                      **kw)
    for i in range(len(streamed)):
        np.testing.assert_array_equal(whole[i].pos, streamed[i].pos)
    assert len(whole) == len(streamed) + 1


def test_compose_matches_jax_and_refuses(tmp_path):
    f = _files(tmp_path, seed=2)
    j1, t1 = _pair("xyz", raw_file=f["xyz"], atom_types=["H", "C", "N", "O"],
                   **BASE)
    j2, t2 = _pair("md", top_file=f["gro"], traj_file=f["trr"],
                   atom_types=["H", "C", "N", "O"], **BASE)
    jc = j_datasets.ComposeDatasets([j1, j2])
    tc = datasets.ComposeDatasets([t1, t2])
    assert len(tc) == len(t1) + len(t2)
    _same_samples(jc, tc)
    assert tc.atom_types == t1.atom_types
    # node_nf mismatch
    j3, t3 = _pair("xyz", raw_file=f["xyz"],
                   atom_types=["H", "C", "N", "O", "F"], **BASE)
    for mod, parts in ((j_datasets, [j1, j3]), (datasets, [t1, t3])):
        with pytest.raises(ValueError, match="node_nf mismatch"):
            mod.ComposeDatasets(parts)
    # a lazy dataset: JAX fails on its missing sample list, the port says
    # which type it refuses
    jl, tl = _pair("trr", traj_file=f["trr"], atom_types=["Ar"], **BASE)
    with pytest.raises(AttributeError):
        j_datasets.ComposeDatasets([jl])
    with pytest.raises(ValueError, match="lazy dataset type 'trr'"):
        datasets.ComposeDatasets([t1, tl])


def test_registry_matches_jax():
    names = ("lj", "lig", "sdf", "hdf5", "md", "largemd", "trr", "xyz")
    for n in names:
        assert datasets.get_dataset_class(n).__name__ == \
            j_datasets.get_dataset_class(n).__name__
    assert sorted(datasets.DATASET_REGISTRY) == sorted(
        j_datasets.DATASET_REGISTRY)
    with pytest.raises(ValueError) as je:
        j_datasets.get_dataset_class("pdbx")
    with pytest.raises(ValueError) as te:
        datasets.get_dataset_class("pdbx")
    assert str(je.value) == str(te.value)


def _fake_mdanalysis(n_frames=3, seed=4):
    """A minimal ``MDAnalysis``: ``Universe(top, traj)`` with atoms
    (element, mass, positions, velocities) and a trajectory of frames."""
    rng = np.random.default_rng(seed)
    pos = rng.normal(size=(n_frames, 3, 3)) * 3
    vel = rng.normal(size=(n_frames, 3, 3))
    elems, masses = ["O", "", ""], [16.0, 1.008, 12.011]

    class Atom:
        def __init__(self, e, m):
            self.element, self.mass = e, m

    class Atoms(list):
        positions = velocities = None

    class TS:
        def __init__(self, v):
            self.has_velocities = v

    class Universe:
        def __init__(self, top, traj):
            self.atoms = Atoms(Atom(e, m) for e, m in zip(elems, masses))
            self._vel = not str(traj).endswith(".xyz")

        @property
        def trajectory(self):
            for i in range(n_frames):
                self.atoms.positions = pos[i]
                self.atoms.velocities = vel[i]
                yield TS(self._vel)

    return types.SimpleNamespace(Universe=Universe)


@pytest.mark.parametrize("traj", ["a.trr", "a.xyz"])
def test_md_mdanalysis_branch_matches_jax(tmp_path, monkeypatch, traj):
    monkeypatch.setitem(sys.modules, "MDAnalysis", _fake_mdanalysis())
    assert readers._mdanalysis_or_none() is j_readers._mdanalysis_or_none()
    jd, td = _pair("md", top_file="a.gro", traj_file=traj,
                   atom_types=["H", "C", "O"], r_cut=3.0,
                   box=[30.0, 30.0, 30.0], dist_unit="nm",
                   time_unit="femto")
    _same_samples(jd, td)
    assert td[0].z == ["O", "H", "C"]


# ---------------------------------------------------------------------------
# utils/helpers.py
# ---------------------------------------------------------------------------

def test_helpers_match_jax():
    rng = np.random.default_rng(8)
    z = rng.normal(size=(3, 4, 2))
    mask = rng.uniform(size=(3, 4, 1)) > 0.3
    t = torch.from_numpy
    assert float(helpers.log_gaussian(t(z))) == pytest.approx(
        float(j_helpers.log_gaussian(jnp.asarray(z))), abs=TOL)
    assert float(helpers.log_gaussian(t(z), t(mask))) == pytest.approx(
        float(j_helpers.log_gaussian(jnp.asarray(z), jnp.asarray(mask))),
        abs=TOL)
    pos = rng.normal(size=(7, 3)) * 4
    np.testing.assert_array_equal(
        helpers.get_box_len(t(pos)).numpy(),
        np.asarray(j_helpers.get_box_len(jnp.asarray(pos))))
    idx = np.array([[0, 2, 4], [1, 5, -1]])
    np.testing.assert_array_equal(
        helpers.one_hot(t(idx), 5).numpy(),
        np.asarray(j_helpers.one_hot(jnp.asarray(idx), 5)))
    data = rng.normal(size=(9, 3))
    seg = np.array([0, 2, 2, 1, 0, 4, 2, 1, 7])     # 7: dropped (>= 5)
    for name in ("unsorted_segment_sum", "unsorted_segment_mean"):
        np.testing.assert_allclose(
            getattr(helpers, name)(t(data), t(seg), 5).numpy(),
            np.asarray(getattr(j_helpers, name)(jnp.asarray(data),
                                                jnp.asarray(seg), 5)),
            rtol=0, atol=TOL)
    x = rng.normal(size=(4, 6))
    m = rng.uniform(size=(4, 6)) > 0.5
    m[2] = False
    for axis in (None, 0, 1):
        np.testing.assert_allclose(
            helpers.masked_mean(t(x), t(m), axis=axis).numpy(),
            np.asarray(j_helpers.masked_mean(jnp.asarray(x), jnp.asarray(m),
                                             axis=axis)), rtol=0, atol=TOL)
    for elem, mass in (("", 1.008), ("", 12.011), ("", 35.45), ("Na", 0.0)):
        assert helpers.get_element(elem, mass) == \
            j_helpers.get_element(elem, mass)
    for mod in (helpers, j_helpers):
        with pytest.raises(ValueError, match="cannot guess"):
            mod.get_element("", 80.0)
