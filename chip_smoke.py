#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``enflow_tpu_torch``) on one NVIDIA
card: ``python3 chip_smoke.py`` from the repository root.

Phases (each prints its own line; any failure exits non-zero):

1. device — a CUDA card must be present; prints ``nvidia-smi``'s name and
   power limit.
2. build  — compiles ``enflow_tpu_torch/csrc/egcl_allpairs.cu`` with nvcc
   (a fresh build from the checkout's sources).
3. kernel — the fused all-pairs EGCL kernels (forward K1, input-gradient
   backward K2) against their plain PyTorch version on the same inputs, at
   the main-path shape (B=1024, N=13, nf=5, H=128) and a ragged shape
   (B=37, N=11, two padded atoms, periodic box 3.0), in bf16 and f32; each
   kernel and the plain version timed with CUDA events over back-to-back
   calls, so the wrapper's host work overlaps the device work before it.
   A molecule too large for the kernel's shared memory must be refused.
4. flow   — ``reverse_core(forward_core(x)) == x`` through the kernel, f32.
5. smc    — the main path: the port's driver runs ``mode: sample, algo:
   smc`` on LJ13 (1024 particles, 8 temperatures, 1 HMC sweep of 5
   leapfrog steps, 5 flow steps at H=128, bf16 compute); 1 warm-up and 3
   timed runs, each checked for the launch counts the code implies.

``python3 chip_smoke.py --profile [FILE]`` runs phases 1-2 and then, in
place of the rest, one warm-up and one SMC run of phase 5 under
``torch.profiler`` tracing device activity only: device time by kernel,
and the device's busy time and idle share of that traced run's wall time
(which includes the tracing's own cost); the full table goes to FILE when
one is given.

The last two lines are the kernels' JSON record and
``{"ok": true, "device": {...}}``; the card's name and power limit are
printed on their own line before them.
"""

import argparse
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# published H100 SXM peaks (NVIDIA data sheet, dense): the bound's rates
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12

MAIN = dict(B=1024, N=13, nf=5, H=128)
RAGGED = dict(B=37, N=11, nf=5, H=128, n_pad=2, box=3.0)
# kernel vs plain, max |kernel - plain| / max |plain| per output. The plain
# version rounds where the kernel rounds, so they differ by summation order
# only: the sound kernel reads <= 4.4e-7 in f32 and <= 2.44e-3 in bf16 (a
# bf16 ulp at a value that a different order pushed across a rounding
# boundary). Deliberate faults (chip_mutants.py) read >= 7.5e-2 when edges
# are dropped or mis-masked, and 6.45e-3 for one misplaced bf16 rounding;
# the bf16 limit sits between the sound reading and that weakest fault.
TOL = {"float32": 1e-4, "bfloat16": 4e-3}


def require(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def phase(name, msg):
    print(f"[{name}] {msg}", flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, reps=25, calls=10, warmup=3):
    """Median device time per call of ``fn``: CUDA events around ``calls``
    back-to-back calls, so the host work of each call after the first
    overlaps the device work queued before it."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return statistics.median(times)


def edge_inputs(shape, dtype, seed):
    """EGCL params (init_egcl) and molecule state on the card."""
    import torch
    from enflow_tpu_torch.nn.egcl import EGCLConfig, init_egcl
    from enflow_tpu_torch.ops.egcl_allpairs import split_params

    B, N, nf, H = shape["B"], shape["N"], shape["nf"], shape["H"]
    gen = torch.Generator().manual_seed(seed)
    p = init_egcl(gen, EGCLConfig(nf, H), torch.float32, "cuda")
    W1a, W1b, w1r, b1 = split_params(p["edge_nn"][0]["w"],
                                     p["edge_nn"][0]["b"], nf)
    weights = tuple(w.to(dtype).contiguous() for w in (
        W1a, W1b, w1r, b1, p["edge_nn"][1]["w"], p["edge_nn"][1]["b"][None],
        p["coord_nn"][0]["w"], p["coord_nn"][0]["b"][None],
        p["coord_nn"][1]["w"]))
    mask = torch.ones((B, N), dtype=torch.bool)
    if "n_pad" in shape:
        mask[:, N - shape["n_pad"]:] = False
    f32 = torch.float32
    h = torch.randn((B, N, nf), generator=gen, dtype=f32) * mask[..., None]
    if "box" in shape:
        pos = torch.rand((B, N, 3), generator=gen, dtype=f32) * 6.0 - 3.0
        box = torch.full((B, 3), shape["box"], dtype=f32)
    else:
        pos = torch.randn((B, N, 3), generator=gen, dtype=f32) * 1.2
        box = torch.full((B, 3), 1e3, dtype=f32)
    pos = pos * mask[..., None]
    dagg = torch.randn((B, N, H), generator=gen, dtype=f32)
    dfsum = torch.randn((B, N, 3), generator=gen, dtype=f32)
    c = lambda t, dt=dtype: t.to(device="cuda", dtype=dt).contiguous()
    return (c(h), c(pos, torch.float32), c(box, torch.float32),
            c(mask, dtype), weights, c(dagg), c(dfsum), mask.cuda())


def work(shape, dtype_name, mask):
    """(fwd FLOP, bwd FLOP, fwd bytes, bwd bytes) this input needs: FLOPs
    over the valid pairs (i != j, both real) plus the per-atom terms; each
    input byte read once and each output byte written once."""
    B, N, nf, H = shape["B"], shape["N"], shape["nf"], shape["H"]
    n_real = mask.sum(dim=1).double()
    pairs = float((n_real * (n_real - 1)).sum())
    atoms = float(n_real.sum())
    # per real atom: h W1a and h W1b (the first layer's only products)
    fwd_atom = 2 * 2 * nf * H
    # per pair: z1 = hA_i + hB_j + b1 + r2 w1r, the W2 and W3 products, the
    # gate's dot with w4
    fwd_edge = 4 * H + 4 * H * H + 2 * H
    bwd_edge = fwd_edge + 4 * H * H + 4 * H        # recompute + transposes
    fwd = pairs * fwd_edge + atoms * fwd_atom
    bwd = pairs * bwd_edge + atoms * 2 * fwd_atom  # recompute + dh
    s = 2 if dtype_name == "bfloat16" else 4
    w = s * (2 * nf * H + 2 * H * H + 5 * H)
    ins = s * B * N * (nf + 1) + 4 * B * N * 3 + 4 * B * 3 + w
    fwd_b = ins + s * B * N * (H + 3)
    bwd_b = ins + s * B * N * (H + 3) + s * B * N * nf + 4 * B * N * 3
    return fwd, bwd, fwd_b, bwd_b


def kernel_phase():
    import torch
    from enflow_tpu_torch.ops import egcl_allpairs as ops

    # the largest molecule that fits in shared memory, and a larger one
    # refused
    lib = ops._library()
    limit = lib.egcl_allpairs_smem_limit()
    largest = {f"{dname} {'bwd' if bwd else 'fwd'}": max(
        n for n in range(1, 257)
        if lib.egcl_allpairs_smem_bytes(code, n, 5, 128, bwd) <= limit)
        for code, dname in ((1, "bf16"), (0, "f32")) for bwd in (0, 1)}
    phase("kernel", "largest N at nf=5, H=128: " + ", ".join(
        f"{k} {v}" for k, v in largest.items()))
    h, pos, box, mask_f, W, dagg, dfsum, _ = edge_inputs(
        dict(B=1, N=64, nf=5, H=128), torch.bfloat16, seed=11)
    try:
        ops.allpairs_edges_bwd(h, pos, box, mask_f, W, dagg, dfsum)
    except ValueError as e:
        require("shared memory" in str(e), f"unclear refusal: {e}")
        phase("kernel", f"N=64 bf16 backward refused: {e}")
    else:
        raise RuntimeError("a molecule beyond shared memory was launched")

    record = {}
    for sname, shape in (("main", MAIN), ("ragged", RAGGED)):
        for dname, dtype in (("bfloat16", torch.bfloat16),
                             ("float32", torch.float32)):
            h, pos, box, mask_f, W, dagg, dfsum, mask = edge_inputs(
                shape, dtype, seed=11)
            k_out = ops.allpairs_edges_fwd(h, pos, box, mask_f, W)
            k_grad = ops.allpairs_edges_bwd(h, pos, box, mask_f, W, dagg,
                                            dfsum)
            p_out = ops.allpairs_edges_plain(h, pos, box, mask_f, W)
            p_grad = ops.allpairs_edges_plain_bwd(h, pos, box, mask_f, W,
                                                  dagg, dfsum)
            torch.cuda.synchronize()
            errs = {}
            for name, k, p in zip(("agg", "f_sum", "dh", "dpos"),
                                  k_out + k_grad, p_out + p_grad):
                require(k.shape == p.shape and k.dtype == p.dtype,
                        f"{name}: kernel {k.shape}/{k.dtype} vs plain "
                        f"{p.shape}/{p.dtype}")
                require(bool(torch.isfinite(k).all()), f"{name} not finite")
                d = float((k.float() - p.float()).abs().max())
                rel = d / max(float(p.float().abs().max()), 1e-6)
                errs[name] = (d, rel)
            ok = all(rel <= TOL[dname] for _, rel in errs.values())
            phase("kernel", f"{sname} {dname} B={shape['B']} N={shape['N']}"
                  " max_abs/rel err: " + "  ".join(
                      f"{n} {a:.3e}/{r:.2e}" for n, (a, r) in errs.items())
                  + f"  tol {TOL[dname]:g} -> {'ok' if ok else 'FAIL'}")
            require(ok, f"kernel disagrees with plain ({sname}, {dname})")

            t_k_f = cuda_time_ms(lambda: ops.allpairs_edges_fwd(
                h, pos, box, mask_f, W))
            t_k_b = cuda_time_ms(lambda: ops.allpairs_edges_bwd(
                h, pos, box, mask_f, W, dagg, dfsum))
            t_p_f = cuda_time_ms(lambda: ops.allpairs_edges_plain(
                h, pos, box, mask_f, W), reps=20, calls=5)
            t_p_b = cuda_time_ms(lambda: ops.allpairs_edges_plain_bwd(
                h, pos, box, mask_f, W, dagg, dfsum), reps=20, calls=5)
            fl_f, fl_b, by_f, by_b = work(shape, dname, mask)
            peak = PEAK_FLOPS[dname]
            bounds = {}
            for key, fl, by in (("fwd", fl_f, by_f), ("bwd", fl_b, by_b)):
                t_ops, t_bytes = fl / peak * 1e3, by / PEAK_BYTES * 1e3
                bounds[key] = (max(t_ops, t_bytes),
                               "operations" if t_ops >= t_bytes else "bytes",
                               fl, by)
            phase("kernel", f"{sname} {dname} time ms: fwd kernel "
                  f"{t_k_f:.4f} plain {t_p_f:.4f} bound {bounds['fwd'][0]:.4f}"
                  f" ({bounds['fwd'][1]}, {bounds['fwd'][2] / 1e9:.2f} GFLOP)"
                  f" | bwd kernel {t_k_b:.4f} plain {t_p_b:.4f} bound "
                  f"{bounds['bwd'][0]:.4f} ({bounds['bwd'][1]}, "
                  f"{bounds['bwd'][2] / 1e9:.2f} GFLOP)")
            record[(sname, dname)] = dict(
                err_fwd=max(errs["agg"][0], errs["f_sum"][0]),
                err_bwd=max(errs["dh"][0], errs["dpos"][0]),
                ms_fwd=t_k_f, ms_bwd=t_k_b, plain_fwd=t_p_f, plain_bwd=t_p_b,
                bound_fwd=bounds["fwd"], bound_bwd=bounds["bwd"])
    return record


def flow_phase():
    import torch
    from enflow_tpu_torch.data.system import System
    from enflow_tpu_torch.flow import (FlowConfig, forward_core, init_flow,
                                       reverse_core)
    from enflow_tpu_torch.nn.egcl import EGCLConfig
    from enflow_tpu_torch.ops import egcl_allpairs as ops

    cfg = FlowConfig(n_iter=5, dt=0.05, nbr_mode="all_pairs", exact_ldj=True,
                     egcl=EGCLConfig(5, 128, use_pallas="v3"))
    params = init_flow(torch.Generator().manual_seed(0), cfg, torch.float32,
                       "cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    B, N = 64, 13
    rnd = lambda *s: torch.randn(s, generator=gen, device="cuda",
                                  dtype=torch.float32)
    x = System(h=rnd(B, N, 5), g=rnd(B, N, 5), pos=rnd(B, N, 3),
               vel=rnd(B, N, 3), mask=torch.ones((B, N), dtype=torch.bool,
                                                 device="cuda"),
               box=torch.full((B, 3), 1e3, device="cuda", dtype=torch.float32),
               r_cut=torch.full((B,), 1e2, device="cuda",
                                dtype=torch.float32))
    ops.counts.reset()
    with torch.no_grad():
        y, ldj = forward_core(params, cfg, x)
        back, ldj_r = reverse_core(params, cfg, y)
    torch.cuda.synchronize()
    c = ops.counts
    err = max(float((getattr(back, f) - getattr(x, f)).abs().max())
              for f in ("h", "g", "pos", "vel"))
    err_ldj = float((ldj + ldj_r).abs().max())
    phase("flow", f"round trip f32 B={B}: max |x - reverse(forward(x))| "
          f"{err:.3e}, |ldj_f + ldj_r| {err_ldj:.3e}; kernel launches "
          f"fwd {c.fwd_launches}, plain calls {c.plain_fwd_calls}")
    require(err < 1e-4 and err_ldj < 1e-3, "flow round trip through the "
            "kernel is not the identity")
    require(c.fwd_launches == 10 and c.plain_fwd_calls == 0,
            "flow did not run through the kernel")


SMC_YAML = """\
mode: sample
units: {{time: pico, dist: ang}}
precision: float32
seed: 0
dynamics:
  n_iter: 5
  dt: {dt!r}
  integrator: lf
  nbr_mode: all_pairs
  compute_dtype: bfloat16
  network: {{hidden_nf: 128, node_nf: 5, use_pallas: v3}}
sampling:
  algo: smc
  n_particles: 1024
  n_temps: 8
  mcmc_steps: 1
  step_size: 0.02
  n_leapfrog: 5
  output: {out}
  target: {{type: lj_cluster, n_atoms: 13, kBT: 2.0, c_osc: 0.5}}
"""


def smc_driver(tmp):
    """The port's driver, set up from ``SMC_YAML`` written into ``tmp``."""
    from enflow_tpu_torch.train.driver import Main
    from enflow_tpu_torch.utils.conversion import lj_to_time

    cfg = Path(tmp) / "smc_lj13.yaml"
    cfg.write_text(SMC_YAML.format(dt=lj_to_time(0.05, "pico"),
                                   out=str(Path(tmp) / "samples.npz")))
    main = Main(device="cuda")
    main.setup(str(cfg))
    return main


def smc_phase(card):
    import torch
    from enflow_tpu_torch.ops import egcl_allpairs as ops

    n_iter, n_temps, mcmc_steps, n_leapfrog, P = 5, 8, 1, 5, 1024
    # flow value-and-grads per SMC run: 1 to fill the component caches +
    # one per leapfrog step of every HMC sweep at every temperature
    n_vg = 1 + n_temps * mcmc_steps * n_leapfrog                    # 41
    # forward launches: the proposal's reverse_core (n_iter) + one
    # forward_core per value-and-grad; backward: one per EGCL per vg
    want_fwd, want_bwd = n_iter + n_vg * n_iter, n_vg * n_iter      # 210, 205
    with tempfile.TemporaryDirectory() as tmp:
        main = smc_driver(tmp)
        secs = []
        for run in range(4):
            ops.counts.reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = main.sample()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            c = ops.counts
            launches = (c.fwd_launches, c.bwd_launches)
            require(launches == (want_fwd, want_bwd),
                    f"kernel launches {launches} != {(want_fwd, want_bwd)}")
            require(c.plain_fwd_calls == 0 and c.plain_bwd_calls == 0,
                    "the plain version ran on the main path")
            require(float(res.beta_history[-1]) > 1.0 - 1e-5,
                    "anneal did not reach beta = 1")
            require(math.isfinite(float(res.log_Z)), "log_Z not finite")
            pos = res.particles["pos"]
            require(tuple(pos.shape) == (P, 13, 3)
                    and bool(torch.isfinite(pos).all()),
                    "particles not finite or of the wrong shape")
    from enflow_tpu_torch.sample.smc import ess_from_log_weights
    timed = secs[1:]
    s_per = statistics.median(timed)
    phase("smc", f"LJ13 flow-SMC P={P} n_temps={n_temps} on {card}: "
          f"{P / s_per:.1f} samples/s, {s_per:.4f} s/SMC (median of "
          f"{len(timed)}; runs {', '.join(f'{t:.4f}' for t in secs)} s, "
          f"first is warm-up), log_Z {float(res.log_Z):.4f}, final ESS "
          f"{float(ess_from_log_weights(res.log_weights)):.1f}, launches "
          f"fwd {launches[0]} bwd {launches[1]}, plain calls 0")
    return launches


def profile_phase(card, out_file=None, top=12):
    """One SMC run of the main path under ``torch.profiler``, tracing the
    device only (the lightest trace that sees the kernels): device time by
    kernel, and the device's busy time and idle share of this traced run's
    wall time. The full table goes to ``out_file`` when one is given."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with tempfile.TemporaryDirectory() as tmp:
        main = smc_driver(tmp)
        main.sample()                                   # warm-up
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            main.sample()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        spans.append((e.time_range.start, e.time_range.end))
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + (e.time_range.end - e.time_range.start))
    require(spans, "the profiler recorded no device activity")
    busy, end = 0.0, -math.inf                         # union of the spans
    for s, e in sorted(spans):
        if e > end:
            busy += e - max(s, end)
            end = e
    busy_s = busy * 1e-6
    total_s = sum(t for _, t in by_name.values()) * 1e-6
    egcl = {k: v for k, v in by_name.items() if "egcl_" in k}
    egcl_s = sum(t for _, t in egcl.values()) * 1e-6
    phase("profile", f"LJ13 flow-SMC under torch.profiler on {card}: wall "
          f"{wall:.4f} s, device busy {busy_s:.4f} s (idle share "
          f"{1 - busy_s / wall:.3f}); device time {total_s:.4f} s in "
          f"{len(spans)} device events, of which the EGCL kernels "
          f"{egcl_s:.4f} s ({sum(n for n, _ in egcl.values())} launches) and "
          f"the other {len(by_name) - len(egcl)} kinds {total_s - egcl_s:.4f} s")
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    for name, (n, t) in ranked[:top]:
        phase("profile", f"{t * 1e-3:9.3f} ms {n:6d}x  {name[:110]}")
    if out_file is None:
        return
    out_file = Path(out_file)
    out_file.parent.mkdir(parents=True, exist_ok=True)
    out_file.write_text(
        f"{card}\nwall {wall} s, device busy {busy_s} s\n\n"
        + "\n".join(f"{t:.1f} us {n}x {name}" for name, (n, t) in ranked)
        + "\n")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", nargs="?", const="", default=None,
                    metavar="FILE", help="profile one SMC run instead of "
                    "phases 3-5; write the full table to FILE")
    args = ap.parse_args()
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test needs one",
              file=sys.stderr)
        return 1
    if not (ROOT / "enflow_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository (the "
              "enflow_tpu_torch package is missing)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    phase("device", f"{card} | torch {torch.__version__} CUDA "
          f"{torch.version.cuda} | {kind} x{torch.cuda.device_count()}")

    from enflow_tpu_torch.ops import build
    lib = build.library_path("egcl_allpairs")
    lib.unlink(missing_ok=True)         # always a fresh build
    _, secs, log = build.build("egcl_allpairs")
    regs = [ln.split(":", 1)[1].strip() for ln in log.splitlines()
            if "registers" in ln]
    spills = sum(" 0 bytes spill stores" not in ln
                 for ln in log.splitlines() if "spill stores" in ln)
    phase("build", f"egcl_allpairs.cu -> {lib.name} in {secs:.1f} s; "
          f"ptxas: {'; '.join(regs)}; kernels with spills: {spills}")

    if args.profile is not None:
        profile_phase(card, args.profile or None)
        return 0
    rec = kernel_phase()
    flow_phase()
    n_fwd, n_bwd = smc_phase(card)

    m = rec[("main", "bfloat16")]
    src = "enflow_tpu_torch/csrc/egcl_allpairs.cu"
    kernels = [
        {"name": "egcl_allpairs_fwd", "route": "cuda", "source": src,
         "replaces": "enflow_tpu/ops/egcl_fused_v3.py:365",
         "launches": n_fwd, "max_abs_err": m["err_fwd"], "ms": m["ms_fwd"],
         "plain_ms": m["plain_fwd"], "bound_ms": m["bound_fwd"][0],
         "bound_by": m["bound_fwd"][1], "library_ms": None},
        {"name": "egcl_allpairs_bwd", "route": "cuda", "source": src,
         "replaces": "enflow_tpu/ops/egcl_fused_v3.py:414",
         "launches": n_bwd, "max_abs_err": m["err_bwd"], "ms": m["ms_bwd"],
         "plain_ms": m["plain_bwd"], "bound_ms": m["bound_bwd"][0],
         "bound_by": m["bound_bwd"][1], "library_ms": None},
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
