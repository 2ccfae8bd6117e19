"""Host-side datasets, samples and the padded-batch loader: the port of
``enflow_tpu/data/datasets.py``.

- ``Sample``: one molecule/frame as float64 numpy arrays.
- ``BaseDataset`` / ``InMemoryDataset``: transform plumbing, one-hot
  features, ``g ~ N(0,1)`` from the dataset's numpy generator (the same
  draws as the JAX package for the same seed), processed-file caching.
- ``ComposeDatasets``: the concatenation of in-memory datasets.
- ``get_dataset_class``: the dataset types by name (``lj``, ``lig`` and
  the readers of ``readers.py``: ``sdf``, ``hdf5``, ``md``, ``largemd``,
  ``trr``, ``xyz``).
- ``pad_samples`` / ``DataLoader``: fixed-shape padded ``System`` batches on
  the driver's device; the final partial batch is padded with all-masked
  dummy molecules, and the shuffle order is the JAX package's
  (``np.random.default_rng(seed + epoch)``).

The processed-file cache differs on purpose: the JAX package pickles its
``Sample`` objects, and unpickling one would import the JAX package. The
port never unpickles. It stores its processed dataset as an ``.npz`` of
plain arrays beside the configured path (``processed.pkl`` ->
``processed.torch.npz``, see :func:`torch_processed_path`) and reads only
that file.
"""

from __future__ import annotations

import dataclasses
import os
from abc import ABC, abstractmethod

import numpy as np
import torch

from .. import resolve_device
from ..utils.constants import atom_types as DEFAULT_ATOM_TYPES
from ..utils.helpers import get_box_len_np
from .system import System
from .transforms import NoneTransform


@dataclasses.dataclass
class Sample:
    """One molecular configuration on the host (float64 numpy)."""

    z: list            # atom symbols (host-only metadata)
    h: np.ndarray      # [N, node_nf]
    g: np.ndarray      # [N, node_nf]
    pos: np.ndarray    # [N, 3]
    vel: np.ndarray    # [N, 3]
    box: np.ndarray    # [3]
    r_cut: float
    label: str = ""

    @property
    def num_atoms(self) -> int:
        return self.pos.shape[0]

    @property
    def node_nf(self) -> int:
        return self.h.shape[1]


def torch_processed_path(path: str) -> str:
    """Where the port keeps the processed dataset configured at ``path``:
    the same name with its suffix replaced by ``.torch.npz``."""
    return os.path.splitext(path)[0] + ".torch.npz"


def save_samples(path: str, samples) -> None:
    """Write samples as one ``.npz`` of plain arrays (ragged atoms
    concatenated, with per-sample counts), atomically."""
    n = np.array([s.num_atoms for s in samples], np.int64)
    cat = lambda f: np.concatenate([getattr(s, f) for s in samples])
    payload = dict(
        n_atoms=n, h=cat("h"), g=cat("g"), pos=cat("pos"), vel=cat("vel"),
        z=np.array([sym for s in samples for sym in s.z], dtype=str),
        box=np.stack([s.box for s in samples]),
        r_cut=np.array([s.r_cut for s in samples], np.float64),
        label=np.array([s.label for s in samples], dtype=str))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"   # ranks of one run write at once
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
    os.replace(tmp, path)


def load_samples(path: str) -> list:
    """Read samples written by :func:`save_samples` (no pickle)."""
    with np.load(path, allow_pickle=False) as z:
        d = {k: z[k] for k in z.files}
    ends = np.cumsum(d["n_atoms"])
    out = []
    for i, end in enumerate(ends):
        lo = end - d["n_atoms"][i]
        out.append(Sample(z=[str(s) for s in d["z"][lo:end]],
                          h=d["h"][lo:end], g=d["g"][lo:end],
                          pos=d["pos"][lo:end], vel=d["vel"][lo:end],
                          box=d["box"][i], r_cut=float(d["r_cut"][i]),
                          label=str(d["label"][i])))
    return out


class BaseDataset(ABC):
    """Dataset plumbing (``datasets.py:64-126``). ``device`` is where a
    dataset that simulates its frames runs the simulation."""

    def __init__(self, **params):
        self.transform = params.pop("transform", None) or NoneTransform()
        self.atom_types = params.pop("atom_types", None) or dict(
            DEFAULT_ATOM_TYPES)
        if isinstance(self.atom_types, (list, tuple)):
            self.atom_types = {z: i for i, z in enumerate(self.atom_types)}
        box = params.pop("box", None)
        self.box = None if box is None else np.asarray(box, np.float64)
        r_cut = params.pop("r_cut", None)
        self.r_cut = None if r_cut is None else float(r_cut)
        self.rng = np.random.default_rng(params.pop("seed", None))
        self.device = resolve_device(params.pop("device", None))
        self.input_params = params

    @abstractmethod
    def __len__(self):
        ...

    @abstractmethod
    def __getitem__(self, idx) -> Sample:
        ...

    @property
    def node_nf(self) -> int:
        return len(self.atom_types)

    def _get_sample(self, z, pos, vel=None, label="", box=None, g=None,
                    h=None) -> Sample:
        """One transformed Sample: one-hot ``h`` unless given, ``g ~ N(0,1)``
        from ``self.rng`` unless given (``datasets.py:84-122``)."""
        pos = np.asarray(pos, np.float64)
        if box is None:
            box = self.box if self.box is not None else get_box_len_np(pos)
        box = np.asarray(box, np.float64)
        if self.r_cut is None:
            raise ValueError("r_cut must be set on the dataset")
        if h is None:
            try:
                type_idx = [self.atom_types[s] for s in z]
            except KeyError as e:
                raise ValueError(
                    f"atom symbol {e.args[0]!r} not in the dataset vocabulary "
                    f"{sorted(self.atom_types)}; pass atom_types to the "
                    f"dataset or provide h explicitly") from None
            h = np.eye(len(self.atom_types), dtype=np.float64)[type_idx]
        else:
            h = np.asarray(h, np.float64)
        if vel is None:
            vel = np.zeros_like(pos)
        if g is None:
            g = self.rng.normal(0.0, 1.0, size=h.shape)
        sample = Sample(z=list(z), h=h, g=np.asarray(g, np.float64),
                        pos=pos, vel=np.asarray(vel, np.float64),
                        box=box, r_cut=float(self.r_cut), label=label)
        return self.transform(sample)

    @property
    def max_atoms(self) -> int:
        return max(self[i].num_atoms for i in range(len(self)))


class InMemoryDataset(BaseDataset, ABC):
    """Eagerly processed dataset, cached as ``.npz`` beside the configured
    ``processed_file`` (see the module docstring)."""

    def __init__(self, **params):
        super().__init__(**params)
        self.samples: list[Sample] = []
        processed_file = self.input_params.pop("processed_file", None)
        cache = torch_processed_path(processed_file) if processed_file \
            else None
        if cache and os.path.exists(cache):
            self.samples = load_samples(cache)
        else:
            self.process(**self.input_params)
            if cache:
                save_samples(cache, self.samples)

    @abstractmethod
    def process(self, **params):
        ...

    def append(self, z, pos, vel=None, label="", box=None, g=None, h=None):
        self.samples.append(self._get_sample(z, pos, vel, label, box, g, h))

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx) -> Sample:
        return self.samples[idx]

    @property
    def node_nf(self) -> int:
        return self.samples[0].node_nf if self.samples else len(
            self.atom_types)

    @property
    def max_atoms(self) -> int:
        return max(s.num_atoms for s in self.samples)


class ComposeDatasets(InMemoryDataset):
    """The concatenation of in-memory datasets (``datasets.py:170-187``):
    every part must have the first part's ``node_nf``. A lazy dataset
    (``trr``, ``largemd``) holds no sample list and is refused, as the JAX
    class fails on its missing ``samples``."""

    def __init__(self, datasets):
        self.samples = []
        self.transform = NoneTransform()
        for d in datasets:
            if not hasattr(d, "samples"):
                kind = next((k for k, c in DATASET_REGISTRY.items()
                             if c is type(d)), type(d).__name__)
                raise ValueError(
                    f"cannot compose the lazy dataset type '{kind}': "
                    f"compose concatenates in-memory sample lists; read "
                    f"the frames with type 'md' (or 'xyz') instead")
            if self.samples and d.node_nf != self.node_nf:
                raise ValueError(
                    f"node_nf mismatch composing datasets: {d.node_nf} != "
                    f"{self.node_nf}")
            self.samples += list(d.samples)
        self.atom_types = (datasets[0].atom_types if datasets
                           else dict(DEFAULT_ATOM_TYPES))

    def process(self, **params):
        raise NotImplementedError


def pad_samples(samples, n_max, node_nf, dtype=torch.float32, n_mols=None,
                device=None) -> System:
    """Pad Samples into one fixed-shape ``System`` on ``device``; ``n_mols``
    beyond ``len(samples)`` adds all-masked dummy molecules."""
    B = n_mols or len(samples)
    h = np.zeros((B, n_max, node_nf))
    g = np.zeros((B, n_max, node_nf))
    pos = np.zeros((B, n_max, 3))
    vel = np.zeros((B, n_max, 3))
    mask = np.zeros((B, n_max), dtype=bool)
    box = np.ones((B, 3))
    r_cut = np.ones((B,))
    for i, s in enumerate(samples):
        n = s.num_atoms
        h[i, :n] = s.h
        g[i, :n] = s.g
        pos[i, :n] = s.pos
        vel[i, :n] = s.vel
        mask[i, :n] = True
        box[i] = s.box
        r_cut[i] = s.r_cut
    dev = resolve_device(device)
    t = lambda a: torch.from_numpy(a).to(device=dev, dtype=dtype)
    return System(h=t(h), g=t(g), pos=t(pos), vel=t(vel),
                  mask=torch.from_numpy(mask).to(dev), box=t(box),
                  r_cut=t(r_cut))


class DataLoader:
    """Shuffling, padding batcher: every batch is ``[batch_size, n_max]``.
    ``prefetch`` is accepted for the config schema and has no effect (the
    port assembles batches on the calling thread).

    ``shard = (num_shards, shard_index)`` takes every ``num_shards``-th
    sample of the epoch's order from ``shard_index`` on, for data-parallel
    loading over processes (``batch_size`` is then per shard). The order is
    padded by modular wrap-around to a multiple of ``num_shards``, so every
    shard has as many samples, hence batches, as the others
    (``datasets.py:227-272``)."""

    def __init__(self, dataset, batch_size=1, shuffle=False, seed=0,
                 dtype=torch.float32, device=None, prefetch=0, shard=None):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.dtype = dtype
        self.device = resolve_device(device)
        self.num_shards, self.shard_index = shard or (1, 0)
        self.n_max = dataset.max_atoms
        self.node_nf = dataset.node_nf

    def set_epoch(self, epoch: int):
        self.epoch = int(epoch)

    def _indices(self):
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(idx)
        if self.num_shards > 1 and n % self.num_shards:
            idx = idx[np.arange(-(-n // self.num_shards) * self.num_shards)
                      % n]
        return idx[self.shard_index::self.num_shards]

    def __len__(self):
        n = len(self._indices())
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        idx = self._indices()
        for b in range(len(self)):
            chunk = idx[b * self.batch_size:(b + 1) * self.batch_size]
            yield pad_samples([self.dataset[i] for i in chunk], self.n_max,
                              self.node_nf, self.dtype,
                              n_mols=self.batch_size, device=self.device)


# --- registry (the JAX package's reflection scheme) -----------------------

DATASET_REGISTRY = {}


def register_dataset(name):
    def deco(cls):
        DATASET_REGISTRY[name] = cls
        return cls
    return deco


def get_dataset_class(name):
    # the registry fills itself on first use (the dataset modules import
    # this one, so they cannot be imported at its top)
    from . import lig, lj, readers  # noqa: F401
    try:
        return DATASET_REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown dataset type '{name}'; available: "
            f"{sorted(DATASET_REGISTRY)}") from None
