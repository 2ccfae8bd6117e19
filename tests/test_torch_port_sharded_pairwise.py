"""Port parity: the ring pair energies (``parallel/pairwise.py``) and the
collective interface of the in-process form (``parallel/collectives.py``).

The same numpy positions go through the JAX package's ring energies under
``shard_map`` on 4 of its virtual CPU devices, the port's on K = 4 virtual
devices in one process, and the port's dense energies; values and
gradients agree to float64 round-off (1e-10), with and without padded
atoms.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from enflow_tpu.parallel import pairwise as jpw
from enflow_tpu.parallel.mesh import get_mesh as j_get_mesh

from enflow_tpu_torch.flow.loss import lj_potential
from enflow_tpu_torch.parallel import pairwise as pw
from enflow_tpu_torch.parallel.collectives import VirtualAxis
from enflow_tpu_torch.parallel.mesh import get_mesh
from enflow_tpu_torch.sample import targets
from enflow_tpu_torch.sim.potentials import softened_lj_energy
from torch_threads import one_torch_thread  # noqa: F401

K = 4
TOL = 1e-10


@pytest.fixture(scope="module")
def meshes():
    return (j_get_mesh(("atom",), devices=jax.devices()[:K]),
            get_mesh(("atom",), (K,), virtual_devices=K))


def _batch(B, N, n_real, seed, scale=3.0):
    rng = np.random.default_rng(seed)
    mask = np.arange(N)[None, :] < np.asarray(n_real)[:, None]
    pos = rng.uniform(-scale, scale, (B, N, 3)) * mask[..., None]
    return pos, np.broadcast_to(mask, (B, N)).copy()


def _j_ring(jmesh, body, pos, mask):
    """A JAX ring body ``(pos_blk, mask_blk) -> [B]`` under shard_map, and
    its gradient in the positions."""
    f = jax.shard_map(body, mesh=jmesh,
                      in_specs=(P(None, "atom"), P(None, "atom")),
                      out_specs=P())
    val, grad = jax.jit(jax.value_and_grad(
        lambda p, m: f(p, m).sum()))(jnp.asarray(pos), jnp.asarray(mask))
    return np.asarray(f(jnp.asarray(pos), jnp.asarray(mask))), \
        np.asarray(grad)


def _t_ring(ax, body, pos, mask):
    p = torch.tensor(pos, requires_grad=True)
    val = ax.collapse(body(ax.split(p), ax.split(torch.tensor(mask))))
    grad, = torch.autograd.grad(val.sum(), p)
    return val.detach().numpy(), grad.numpy()


def _t_dense(fn, pos):
    p = torch.tensor(pos, requires_grad=True)
    val = fn(p)
    grad, = torch.autograd.grad(val.sum(), p)
    return val.detach().numpy(), grad.numpy()


def _close(got, *wants):
    for want in wants:
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("n_real", [64, 50])
def test_ring_softened_lj_energy(meshes, n_real):
    jmesh, mesh = meshes
    pos, mask = _batch(1, 64, [n_real], 0)
    box = np.full(3, 6.0)
    jf = jpw.make_sharded_lj_energy(jmesh, "atom")
    tf = pw.make_sharded_lj_energy(mesh)
    want = (float(jf(jnp.asarray(pos[0]), jnp.asarray(mask[0]),
                     jnp.asarray(box), 0.1, 3.0)),
            np.asarray(jax.grad(lambda p: jf(p, jnp.asarray(mask[0]),
                                             jnp.asarray(box), 0.1, 3.0))(
                jnp.asarray(pos[0]))))
    got = _t_dense(lambda p: tf(p, torch.tensor(mask[0]), torch.tensor(box),
                                0.1, 3.0), pos[0])
    dense = _t_dense(lambda p: softened_lj_energy(
        p, torch.tensor(box), 0.1, 3.0, torch.tensor(mask[0])), pos[0])
    _close(got, want, dense)


@pytest.mark.parametrize("pad", [False, True])
def test_ring_alchemical_lj(meshes, pad):
    """The NLL's pair term, with two coincident atoms (left out by d2 != 0)
    and, padded, a last molecule cut short."""
    jmesh, mesh = meshes
    n_real = [16, 16, 9 if pad else 16]
    pos, mask = _batch(3, 16, n_real, 1, scale=1.5)
    pos[0, 7] = pos[0, 12]
    want = _j_ring(jmesh, lambda p, m: jpw.ring_alchemical_lj(
        p, m, 0.1, "atom"), pos, mask)
    ax = mesh["atom"]
    got = _t_ring(ax, lambda p, m: pw.ring_alchemical_lj(p, m, 0.1, ax),
                  pos, mask)
    dense = _t_dense(lambda p: lj_potential(p, torch.tensor(mask), 0.1), pos)
    _close(got, want, dense)


@pytest.mark.parametrize("pad", [False, True])
def test_ring_pair_terms_min_image(meshes, pad):
    """``ring_pair_terms`` with a periodic box, as ``lj_fluid`` uses it,
    against the JAX package's and the port's dense ``lj_fluid``."""
    jmesh, mesh = meshes
    n_real = [12, 9 if pad else 12]
    pos, mask = _batch(2, 12, n_real, 2, scale=1.25)
    box, cut = 2.5, 1.2

    def term_np(xp):
        def term(d2, valid):
            valid = valid & (d2 < cut * cut)
            r_sq = xp.where(valid, d2, 1.0) + 0.1
            r6 = r_sq ** 3
            e = 4.0 * (1.0 / (r6 * r6) - 1.0 / r6)
            return xp.where(valid, e, 0.0).sum(axis=(1, 2))
        return term

    want = _j_ring(jmesh, lambda p, m: jpw.ring_pair_terms(
        p, m, "atom", term_np(jnp), box=box), pos, mask)
    ax = mesh["atom"]

    def t_term(d2, valid):
        valid = valid & (d2 < cut * cut)
        r_sq = torch.where(valid, d2, torch.ones_like(d2)) + 0.1
        r6 = r_sq ** 3
        e = 4.0 * (1.0 / (r6 * r6) - 1.0 / r6)
        return torch.where(valid, e, torch.zeros_like(e)).sum(dim=(1, 2))

    got = _t_ring(ax, lambda p, m: pw.ring_pair_terms(p, m, ax, t_term,
                                                      box=box), pos, mask)
    _close(got, want)
    if not pad:     # the dense target over all atoms: -u / kBT
        t = targets.lj_fluid(12, box=box, softening=0.1, cutoff=cut)
        dense = _t_dense(lambda p: -t.log_prob(p), pos)
        _close(got, dense)


def test_virtual_axis_collectives():
    """split / gather invert each other; ring_shift hands shard i shard
    i+1's block; psum sums the shards on every shard; broadcast and
    collapse are a replicated tensor's way in and out."""
    ax = VirtualAxis(K)
    x = torch.arange(2 * 8 * 3, dtype=torch.float64).reshape(2, 8, 3)
    blk = ax.split(x)
    assert blk.shape == (K * 2, 2, 3)
    assert torch.equal(blk[2 * 1 + 1], x[1, 2:4])         # shard 1, row 1
    assert torch.equal(ax.gather(blk), x)
    shifted = ax.ring_shift(blk).reshape(K, 2, 2, 3)
    assert torch.equal(shifted, torch.roll(blk.reshape(K, 2, 2, 3), -1, 0))
    s = ax.psum(blk).reshape(K, 2, 2, 3)
    assert all(torch.equal(s[k], blk.reshape(K, 2, 2, 3).sum(0))
               for k in range(K))
    r = torch.tensor([[1.0, 2.0], [3.0, 4.0]])
    assert torch.equal(ax.collapse(ax.broadcast(r)), r)
