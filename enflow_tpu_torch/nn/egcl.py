"""E(n)-equivariant graph convolutional layer (EGCL), the port of
``enflow_tpu/nn/egcl.py``.

Per flow step it returns ``Q [B,N,1]`` (log velocity scale), ``F [B,N,3]``
(equivariant force) and ``G [B,N,nf]`` (node feature update), zeroed on
padded atoms.

The kernels implement the default EGCL only. :func:`plain_route` decides,
from the config alone, which EGCLs run the plain PyTorch path
(``edge_messages`` + ``node_outputs``) instead, on the card as on the CPU:
those with ``attention``, ``norm_diff`` or ``tanh`` on and ``use_pallas``
off, as the JAX package computes them on XLA. With ``use_pallas`` set and
a flag on, the kernel paths raise, as the JAX package does. ``counts``
counts the plain path's calls.

In ``all_pairs`` mode two paths compute the same function:

- ``apply_egcl(all_pairs=True)``: the plain broadcast path over
  ``[B, N, N, ·]`` edge tensors. It serves CPU tensors (the float64
  parity tests) and, on the card, the EGCLs of :func:`plain_route`.
- ``apply_egcl_fused_allpairs``: the edge pipeline through
  ``ops/egcl_allpairs.py`` — the CUDA kernel on the card, its plain version
  on the CPU. On a CUDA tensor every other all-pairs EGCL goes this way,
  whatever ``use_pallas`` says: ``False``, ``True``, ``"v1"``, ``"v2"`` and
  ``"v3"`` all name this same function in ``all_pairs`` mode. In bf16 it
  takes every N (past one warpgroup's shared memory, the block-pair
  kernels), and so does float32, at every hidden width up to 256.

On a gathered neighbor list (the ``dense``/``topk``, ``cell`` and
``images`` modes) ``apply_egcl`` runs the gathered-edge kernel of
``ops/edge_pipeline.py`` on every CUDA tensor but those of
:func:`plain_route`, whatever ``use_pallas`` says (``False``, ``True`` and
``"v1"`` name the same function there).
"""

from __future__ import annotations

import dataclasses

import torch

from .. import resolve_device
from ..ops.build import LaunchCounts
from .mlp import init_linear, apply_linear, init_mlp, apply_mlp, silu

_COMPUTE_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
                   "float64": torch.float64}

counts = LaunchCounts("plain_calls")


@dataclasses.dataclass(frozen=True)
class EGCLConfig:
    node_nf: int
    hidden_nf: int
    coords_weight: float = 1.0
    attention: bool = False
    norm_diff: bool = False
    tanh: bool = False
    # reduced-precision compute for the message-passing internals
    # (e.g. 'bfloat16'); outputs are cast back to the input dtype
    compute_dtype: str | None = None
    # the JAX package's kernel selector; on the card it selects nothing
    # (see the module docstring)
    use_pallas: bool | str = False

    @property
    def edge_in(self) -> int:
        return 2 * self.node_nf + 1  # [h_i, h_j, |dx|^2]


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def init_egcl(gen: torch.Generator, cfg: EGCLConfig, dtype=torch.float32,
              device=None):
    """One EGCL's parameters as a nested dict (the JAX pytree layout), on
    ``device`` (``cuda`` unless the caller asks for another)."""
    device = resolve_device(device)
    H, nf = cfg.hidden_nf, cfg.node_nf
    params = {
        "edge_nn": init_mlp(gen, [cfg.edge_in, H, H], dtype, device),
        "node_nn": init_mlp(gen, [H + nf, H, nf], dtype, device),
        "coord_nn": [
            init_linear(gen, H, H, dtype, device),
            init_linear(gen, H, 1, dtype, device, bias=False,
                        init="xavier_uniform", gain=0.001),
        ],
        "vel_scaling_nn": init_mlp(gen, [nf, H, 1], dtype, device),
    }
    if cfg.attention:
        params["att_nn"] = init_linear(gen, H, 1, dtype, device)
    if cfg.tanh:
        params["coords_range"] = 3.0 * torch.ones((1,), dtype=dtype,
                                                  device=device)
    return params


def edge_messages(params, cfg: EGCLConfig, h_i, h_j, coord_diff, valid):
    """Masked per-edge message ``m [..., I, J, H]`` and clipped gated
    displacement ``trans [..., I, J, 3]`` (``egcl.py:92-128``)."""
    radial = (coord_diff * coord_diff).sum(-1, keepdim=True)
    if cfg.norm_diff:
        coord_diff = coord_diff / (torch.sqrt(radial) + 1.0)
    full = h_j.expand(radial.shape[:-1] + (h_j.shape[-1],))
    h_i = h_i[..., :, None, :].expand(full.shape)
    edge_in = torch.cat([h_i, full, radial], dim=-1)
    m = apply_mlp(params["edge_nn"], edge_in, final_act=silu)
    if cfg.attention:
        m = m * torch.sigmoid(apply_linear(params["att_nn"], m))
    zero = torch.zeros((), dtype=m.dtype, device=m.device)
    m = torch.where(valid[..., None], m, zero)
    gate = apply_linear(params["coord_nn"][1],
                        silu(apply_linear(params["coord_nn"][0], m)))
    if cfg.tanh:
        gate = torch.tanh(gate) * params["coords_range"]
    trans = torch.clamp(coord_diff * gate, -100.0, 100.0)
    trans = torch.where(valid[..., None], trans, zero)
    return m, trans


def node_outputs(params, cfg: EGCLConfig, h, agg, f_sum, count, atom_mask):
    """Per-node heads from aggregated edge quantities; ``(Q, F, G)``."""
    am = atom_mask[..., None]
    zero = torch.zeros((), dtype=h.dtype, device=h.device)
    G = apply_mlp(params["node_nn"], torch.cat([h, agg], dim=-1))
    G = torch.where(am, G, zero)
    F = f_sum / torch.clamp(count, min=1).to(f_sum.dtype)
    F = torch.where(am, F * cfg.coords_weight, zero)
    Q = apply_mlp(params["vel_scaling_nn"], h)
    Q = torch.where(am, Q, zero)
    return Q, F, G


def _cast_compute(params, cfg: EGCLConfig, h):
    if cfg.compute_dtype is None:
        return params, h
    cdt = _COMPUTE_DTYPES[str(cfg.compute_dtype)]
    return _tree_map(lambda x: x.to(cdt), params), h.to(cdt)


def plain_route(cfg: EGCLConfig) -> bool:
    """Whether this EGCL runs the plain path on every device: a variant
    flag (``attention``, ``norm_diff``, ``tanh``) on and ``use_pallas``
    off. The kernels take the default EGCL only."""
    return bool(cfg.attention or cfg.norm_diff or cfg.tanh) and \
        not cfg.use_pallas


def _check_kernel_flags(cfg: EGCLConfig, what: str):
    if cfg.attention or cfg.norm_diff or cfg.tanh:
        raise ValueError(
            f"{what} supports only the default EGCL path; attention/"
            "norm_diff/tanh must be off")


def apply_egcl(params, cfg: EGCLConfig, h, coord_diff, nbr_idx, nbr_mask,
               atom_mask, all_pairs: bool = False):
    """One EGCL on a neighbor structure (``egcl.py:148-204``).

    ``coord_diff [B,N,K,3]`` displacements ``pos_i - pos_j`` (zeroed on
    invalid slots), ``nbr_idx``/``nbr_mask [B,N,K]``, ``atom_mask [B,N]``.
    Returns ``(Q, F, G)``.

    - ``all_pairs``: the plain broadcast path over ``[B,N,N,·]`` edges, for
      CPU tensors and the EGCLs of :func:`plain_route` (on the card every
      other all-pairs EGCL runs :func:`apply_egcl_fused_allpairs`).
    - gathered (``all_pairs=False``): ``h_j = h[b, nbr_idx]`` and
      ``edge_in = [h_i, h_j, |cd|^2]`` in the compute dtype go through the
      gathered-edge kernel (``ops/edge_pipeline.py``) — on the card unless
      :func:`plain_route` says otherwise, and on the CPU when
      ``use_pallas`` names it (``True``/``"v1"``); otherwise
      ``edge_messages`` with sums over K.
    """
    plain = plain_route(cfg)
    if all_pairs:
        if h.is_cuda and not plain:
            raise RuntimeError(
                "the all-pairs apply_egcl is the plain path; on the card it "
                "serves only the attention/norm_diff/tanh variants, and the "
                "all-pairs EGCL runs apply_egcl_fused_allpairs")
        if cfg.use_pallas:
            _check_kernel_flags(cfg, "use_pallas")
    in_dtype = h.dtype
    params, h = _cast_compute(params, cfg, h)
    coord_diff = coord_diff.to(h.dtype)
    if all_pairs:
        h_j = h[:, None, :, :]
    else:
        b = torch.arange(h.shape[0], device=h.device)[:, None, None]
        h_j = h[b, nbr_idx.long()]                                # [B,N,K,nf]
    if not all_pairs and not plain and (h.is_cuda or cfg.use_pallas):
        _check_kernel_flags(cfg, "the gathered-edge kernel")
        Q, F, G = _apply_egcl_gathered(params, cfg, h, h_j, coord_diff,
                                       nbr_mask, atom_mask)
    else:
        counts.plain_calls += 1
        m, trans = edge_messages(params, cfg, h, h_j, coord_diff, nbr_mask)
        count = nbr_mask.sum(dim=2, keepdim=True)
        Q, F, G = node_outputs(params, cfg, h, m.sum(dim=2),
                               trans.sum(dim=2), count, atom_mask)
    return Q.to(in_dtype), F.to(in_dtype), G.to(in_dtype)


def _apply_egcl_gathered(params, cfg: EGCLConfig, h, h_j, coord_diff,
                         nbr_mask, atom_mask):
    """The EGCL tail through the gathered-edge kernel
    (``egcl.py:249-280``)."""
    from ..ops.edge_pipeline import fused_edge_pipeline

    B, N, K, nf = h_j.shape
    radial = (coord_diff * coord_diff).sum(-1, keepdim=True)
    edge_in = torch.cat([h[:, :, None, :].expand(B, N, K, nf), h_j, radial],
                        dim=-1)
    A = B * N
    agg, f_sum = fused_edge_pipeline(
        edge_in.reshape(A, K, -1), coord_diff.reshape(A, K, 3),
        nbr_mask.reshape(A, K),
        params["edge_nn"][0]["w"], params["edge_nn"][0]["b"],
        params["edge_nn"][1]["w"], params["edge_nn"][1]["b"],
        params["coord_nn"][0]["w"], params["coord_nn"][0]["b"],
        params["coord_nn"][1]["w"])
    count = nbr_mask.sum(dim=2, keepdim=True)
    return node_outputs(params, cfg, h, agg.reshape(B, N, -1),
                        f_sum.reshape(B, N, 3), count, atom_mask)


def apply_egcl_fused_allpairs(params, cfg: EGCLConfig, h, pos, box,
                              atom_mask):
    """EGCL through the fused all-pairs edge pipeline
    (``ops/egcl_allpairs.py``) from raw per-atom state; the same
    ``(Q, F, G)`` contract as :func:`apply_egcl`."""
    from ..ops.egcl_allpairs import fused_allpairs_edges

    _check_kernel_flags(cfg, "apply_egcl_fused_allpairs")
    in_dtype = h.dtype
    params, h = _cast_compute(params, cfg, h)
    if h.dtype == torch.float64:
        raise ValueError(
            "apply_egcl_fused_allpairs computes in <= f32; for float64 use "
            "apply_egcl (on the CPU) or set compute_dtype")
    agg, f_sum, count = fused_allpairs_edges(params, h, pos, box, atom_mask)
    Q, F, G = node_outputs(params, cfg, h, agg, f_sum, count, atom_mask)
    return Q.to(in_dtype), F.to(in_dtype), G.to(in_dtype)
