#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``enflow_tpu_torch``) on one NVIDIA
card: ``python3 chip_smoke.py`` from the repository root.

Phases (each prints its own lines and its seconds; any failure exits
non-zero):

1. device — a CUDA card must be present; prints ``nvidia-smi``'s name and
   power limit.
2. build  — compiles every ``enflow_tpu_torch/csrc/*.cu`` with nvcc, one
   process per source, all at once (fresh builds from the checkout).
3. kernel — the fused all-pairs EGCL kernels (forward K1, input-gradient
   backward K2: the Hopper kernels of egcl_allpairs_sm90.cu in bf16; in
   f32 the tiled K1 and K2 of egcl_allpairs_f32.cu, the K2 on its own
   launch counter) against their plain PyTorch version on the same
   inputs, at the main-path shape (B=1024, N=13, nf=5, H=128) and a ragged
   shape (B=37, N=11, two padded atoms, periodic box 3.0), in bf16 and
   f32, and in bf16 at a large shape (B=64, N = the backward's largest)
   and at H=64; a second launch of each must give the same bits. Both
   dtypes at H=96 run the same kernels at 128, the wrapper zero-padding
   the weights (``padded_launches``). Other widths: bf16 K1, K2 and K2 p
   at H = 96, 100, 160, 192 and 256 and N = 13, 55 and 147 (B=16; 96 and
   100 padded to 128, 160 to 192; 192 and 256 on the block pairs with
   streamed weights, route ``"wide"``), and f32 at H=96, N=147, each one
   launch on the route the wrapper names against the plain version, a
   second launch bitwise equal. Each kernel and the plain version timed
   at
   the main, ragged and H=96 shapes with CUDA events over back-to-back
   calls, so the wrapper's host work overlaps the device work before it.
   The bf16 parameter-gradient backward must take N >= 55 (vi_lj55.yaml).
   Past the one-molecule kernels' shared memory bf16 K1, K2 and K2 p go
   to the block-pair kernels of the same file: one atom past each limit
   (B=16), at N=147 (B=64) and at N=512 (B=2), each on its own counter
   (the one-molecule counters untouched) against the plain version, a
   second launch bitwise equal; a launch the card refuses raises. f32 K1,
   K2 and K2 p past the tiled f32 kernels' limits go to the f32 block-pair
   kernels of egcl_allpairs_f32.cu: one atom past each limit (N = 143 /
   520 / 71), at N=147 (B=64) and K2 at N=561 (B=2), each on its own
   counter against the plain version, a second launch bitwise equal. The
   seam: at each one-molecule limit both routes side by side at B=64 and
   B=1024, bf16 and f32 (CUDA events, device time, how far apart their
   outputs are).
4. params — K2 with the nine parameter gradients (bf16: the Hopper
   kernel; f32: the tiled f32 kernel) against its plain version at the VI
   shape (B=512, N=13, nf=5, H=128), the same as LJ13 icosahedra, and the
   ragged shape, in bf16 and f32, and in bf16 at a large shape (B=64, N =
   its largest) and at H=64, and in both dtypes at H=96 (zero-padded to
   128); one launch each on its counter, a second launch must
   give the same bits, dh/dpos also against the input-gradient kernel's.
   Timed as in phase 3 at the first three shapes and at H=96 beside the
   input-gradient variant, with the MUFU and elementwise floors in bf16.
5. pair   — the pair-energy kernel K7 (energy and gradient) against its
   plain version: form r2 at B=30, N=13 and at B=30, N=4 (eight
   molecules a block); form r at B=1, N=13 (atoms on the half-box
   rounding boundary), at B=2, N=1500 (3 padded, box 12; column splits),
   at B=1, N=2 one ulp past half a box (where a reciprocal of the box
   would round the min-image integer the other way) and at
   generate.yaml's 2,944 atoms (100 A box, cutoff 3, the grid start
   jittered); form r with the MD potential's coincident flag at B=1, N=13
   with two coincident atoms (the flag adds 4(s^-12 - s^-6) and no
   force). A second launch must give the same bits; each timed with CUDA
   events and as device time beside its bound.
6. flow   — ``reverse_core(forward_core(x)) == x`` through the kernel, f32.
6b. flags — a flagged EGCL (attention, norm_diff, tanh; use_pallas off)
   in all_pairs and images mode on the card: the plain route (its own
   counter, no kernel launch), against float64 on the CPU.
7. smc    — the sampling path: the port's driver runs ``mode: sample,
   algo: smc`` on LJ13 (1024 particles, 8 temperatures, 1 HMC sweep of 5
   leapfrog steps, 5 flow steps at H=128, bf16 compute); 1 warm-up and 3
   timed runs, each checked for the launch counts the code implies.
8. vi     — the flow-VI path: ``example/vi_lj13.yaml`` at full width with
   its epochs and steps cut to VI_EPOCHS x VI_STEPS, in a temporary
   directory; a 1-epoch resume; one ``stl: true`` epoch; then
   ``example/sample_lj13.yaml`` as committed from the checkpoint they
   wrote. Each run is checked for the launch counts the code implies. The
   checkpoint goes on to phases 8b-8d.
8b. mcmc  — ``example/sample_lj13_mcmc.yaml`` from that checkpoint with
   ``algo: hmc`` (as committed: 64 chains, dual averaging, 200 sweeps of
   5 steps), ``mala`` (the same sweeps) and ``nuts`` (NUTS_CUT sweeps):
   one flow reverse (5 bf16 K1), the chains on the LJ energy alone.
8c. remc  — ``example/remc_lj13.yaml`` as committed (6 slots x 512
   chains, 200 rounds; bf16 K1/K2 over the flattened B=3,072) with MBAR,
   monolithic and in segments of REMC_CHUNK rounds, bitwise equal; then
   K1/K2 at B=3,072 against their plain version, timed.
8d. ti    — ``example/ti_lj13.yaml`` (25 nodes x 256 chains) with its
   sweeps cut to TI_CUT, monolithic and in segments of TI_CHUNK sweeps,
   bitwise equal; the seconds a sweep and their extrapolation to the
   committed 400.
9. vi55   — ``example/vi_lj55.yaml`` (LJ55, 256 particles, H=128, bf16)
   cut to 1 epoch x VI55_STEPS steps in a temporary directory: 5 K1 + 5
   parameter-gradient K2 launches per step at N=55, no plain call, finite
   losses, a checkpoint and a metrics CSV; then K1 and K2 p against their
   plain version at its shape (B=256, N=55), and timed beside it, their
   bounds and floors.
9b. sharded (after vi55, from its LJ55 checkpoint) — the atom-sharded
   paths (ROADMAP A7) on the in-process mesh of 4 virtual devices, the
   ring EGCL and ring pair terms as plain PyTorch on the card (one
   ``ring_calls`` count an EGCL; every kernel counter 0 on these paths):
   (a) ``example/sample_sharded.yaml`` as committed (LJ55 padded to 56
   atoms, 1024 particles, 16 temperatures, bf16, H=128), after
   ``propose``, ``log_q0``, ``log_p`` and their gradients held against the
   dense padded oracle (``mesh=None``, ``n_pad`` 56, the all-pairs f32
   kernels) on SHARDED_CHECK_P particles in f32 (TOL_SHARDED, relative to
   each output's largest magnitude): beta 1, finite ``log_Z``, the npz
   trimmed to 55 atoms, the ring calls the code implies, the peak memory;
   (b) ``example/train_sharded.yaml``: its LJ-128 dataset (the MD's K7 r
   on the card) and 2 of its 10 epochs, the first step's loss and
   parameter gradient held against the dense port (K5/K6, K7 r2) on the
   same batch and noise, s/step, then a 1-epoch resume; (c)
   ``example/sample_fluid.yaml`` (2,944 atoms, a fresh drift flow) as far
   as memory allows: the densities without a gradient at 2,944 atoms, a
   value-and-grad on one particle and a short fixed-schedule SMC (2
   temps, 1 x 2 HMC) on as many particles as fit; the same at FLUID_N
   atoms with the box scaled to keep rho*; each with its peak bytes; (d)
   ``parallel.dryrun.dryrun_multichip(4)``.
10. train — the training path: ``example/train.yaml`` (3 epochs) through
   the port's driver in a temporary directory: the LJ MD dataset on the
   card, then NLL steps, each checked for the launch counts the code
   implies; then a 1-epoch rerun that resumes from the checkpoint.
10f. generate (after train) — ``example/generate.yaml`` as committed
   (2,944 atoms in a 100 A box, 200 FIRE + 10,000 Langevin steps, a frame
   every 100, ``nbr_capacity: auto`` in the default dense mode, i.e. the
   top-k format; f32, H=128 from the checkpoint) through the port's
   driver in train's directory, from the checkpoint train wrote: the auto
   capacity, MD and flow seconds, 10,300 K7 r and 15 K5 launches
   (reverse, forward, reverse), no plain call, the round-trip lines True
   True, ``h.out`` one-hot of [2944, node_nf], ``test_out.xyz``, 100 log
   rows and 100 trajectory models. A capacity check that refuses a later
   frame is answered by one rerun with the recommended capacity, said on
   the phase's line. Then the first frame reversed again in ``cell`` mode
   (auto cells): the neighbour sets equal the top-k build's, the
   positions within the f32 ``TOL_EDGE``.
10g. dataset — ``mode: dataset`` on generate.yaml's dataset section with
   n_iter cut to 1,000 (node_nf, temp and softening as generate injects
   them): the processed cache, the log and the trajectory written; a
   second run reads the cache back.
10b. lj55 — the LJ55 pipeline: (a) ``example/sample_lj55.yaml`` as
   committed (1024 particles, 16 temperatures in segments of 8 with a
   stage checkpoint every 8, a fresh shift flow, bf16: K1 and the
   input-gradient K2 at B=1024, N=55, the latter at its limit); (b)
   ``example/vi_lj55_coupled.yaml`` cut to 1 epoch x LJ55C_STEPS steps (a
   kick and a drift EGCL a flow step: 10 K1 + 10 K2 p a step); (c) from
   (b)'s checkpoint, ``sample_lj55.yaml`` with ``position_update:
   coupled`` at 4 temperatures, chunked and monolithic, which must agree
   bit for bit; each run checked for the launch counts the code implies;
   then K1 and K2 at B=1024, N=55 timed beside their plain version.
10j. lj147 (after lj55) — LJ147 through the port's driver, every EGCL on
   the bf16 block-pair kernels: ``example/vi_lj55.yaml`` with the target's
   ``n_atoms: 147`` at 256 particles, 1 epoch x LJ147_STEPS steps (5 K1 +
   5 K2 p a step), then ``sample_lj55.yaml`` with ``n_atoms: 147`` from
   its checkpoint at 256 particles and 4 temperatures in one segment (210
   K1 + 205 K2); no plain call and no one-molecule launch, beta 1, finite
   log_Z, particles and losses, outputs on the card. Then K1, K2 p and K2
   at B=256, N=147 against the plain version, and K2 also at B=1024,
   timed (events, device time, bound, MUFU / elementwise floors).
10k. lj147_f32 (after lj147) — the same in float32 (``compute_dtype:
   float32``): (a) ``vi_lj55.yaml`` at ``n_atoms: 147``, 256 particles, 1
   x LJ147_STEPS steps (5 f32 block-pair K1 + 5 f32 block-pair K2 p a
   step); (b) ``sample_lj55.yaml`` at ``n_atoms: 147`` from its
   checkpoint, 256 particles, 4 temperatures (210 f32 block-pair K1 + 205
   tiled f32 K2, within its one-molecule limit); (c) ``sample_lj55.yaml``
   at ``n_atoms: 561`` from a fresh flow, LJ561_P particles, 4
   temperatures (210 f32 block-pair K1 + 205 f32 block-pair K2); no plain
   call and no other launch, beta 1, finite log_Z, outputs on the card;
   then the f32 K1, K2 p and K2 at B=256, N=147 and the block-pair K2 at
   (c)'s shape against the plain version, timed (events, device, bound).
10l. wide (after lj147_f32) — the bf16 EGCL at other hidden widths
   through the port's driver: (a) ``example/vi_lj55.yaml`` with
   ``network.hidden_nf: 256`` and nothing else changed, 1 epoch x
   WIDE_STEPS steps of its 256 particles (5 K1 + 5 K2 p a step); (b)
   ``example/sample_lj55.yaml`` at ``hidden_nf: 256`` from (a)'s
   checkpoint, its 1024 particles at WIDE_TEMPS of its 16 temperatures in
   one segment (210 K1 + 205 K2), every launch on the ``"wide"`` counters;
   (c) ``example/vi_lj13.yaml`` at ``hidden_nf: 96`` (1 x WIDE13_STEPS)
   and ``example/sample_lj13.yaml`` from its checkpoint, on the
   one-molecule kernels at 128 (every launch also on
   ``padded_launches``); no plain call, beta 1, finite log_Z and
   losses, outputs on the card. Then K1, K2
   and K2 p at N=55, H=256 on the streamed block pairs at B=256 and
   B=1024, each against the plain version (read per element,
   ``step_errs``): CUDA events, device time, bound, the L2 bytes their
   weight slabs read, the plan; the partials' sum; the padded launches'
   cost at H=96 against H=128 (B=1024, N=13, K2 p B=512; and K1, K2 p at
   B=256, N=55); each run's kernel share.
10m. wide_f32 (after wide) — the float32 EGCL at 128 < H <= 256 (the f32
   block pairs with W2 and W3 streamed, route ``"f32_wide"``) through the
   port's driver: (a) ``example/vi_ala2.yaml`` with ``network.hidden_nf:
   256`` and nothing else changed (256 particles, N=22, nf=4, float32,
   the force field on the card), 1 epoch x FF_STEPS steps (5 K1 + 5 K2 p
   a step on the ``*_f32_wide_launches`` counters), finite losses and a
   checkpoint; (b) ``example/sample_ala2.yaml`` at ``hidden_nf: 256``
   from (a)'s checkpoint, as committed otherwise (2048 particles x 10
   temps: 260 K1 + 255 K2), beta 1, finite log_Z; no other counter and
   no plain call in either run. Then K1, K2 and K2 p at H = 192 and 256
   and the padded 160 and 200, at WIDE_F32_SHAPES (vi_ala2's B=256 and
   sample_ala2's B=2048 at N=22, nf=4; B=64 at N=55 and B=16 at N=147,
   nf=5), each one launch on its counter against the plain version
   (outputs to TOL, parameter gradients' f32 sums to TOL_PARAM), a second
   launch bitwise equal, timed (CUDA events and device time) beside its
   bound and the plan, the plain version timed at the kernels line's
   shapes; the library's plans at H = 128, 192 and 256.
10n. xwide (after wide_nf) — the all-pairs EGCL past H = 256 (routes
   ``"xwide"`` and ``"f32_xwide"`` of egcl_allpairs_xwide.cu; the bf16 K1
   and K2 on its ring kernels): the library's shared memory, threads and
   scratch tiles a block against tests/egcl_smem_mirror.py (each kind the
   same at every H), K1, K2 and K2 p at H = 300, 320, 384, 512 and 1024 x N = 13,
   55 and 147 in both dtypes against the plain version (bf16 per element,
   its parameter gradients against an f64-summed twin of the plain
   version; f32 to TOL / TOL_PARAM), a second launch bitwise equal, the
   seam at H = 256 beside the route of 256; each kernel at XWIDE_TIMED's
   shapes timed (CUDA events, device time) beside its bound and the plain
   version; the LJ13 SMC at bench.py's settings, ``vi_lj13.yaml`` and
   ``sample_lj13.yaml`` (bf16) and ``vi_ala2.yaml`` and
   ``sample_ala2.yaml`` (float32) at ``hidden_nf: 512``, every launch on
   the xwide counters, none plain, beta 1.
10c. fluid — ``example/vi_fluid.yaml`` (periodic LJ fluid, N=32, box 6.5,
   H=64, bf16, the learned drift) cut to 1 epoch x FLUID_STEPS steps; then
   K1 and K2 p against their plain version at B=256, N=32, H=64 with
   pairs on both sides of the half box and one on it, timed.
10d. dw4  — ``example/vi_dw4.yaml`` (N=4, nf=2, H=64, float32: the tiled
   f32 K1 and K2 p) cut to 1 epoch x DW4_STEPS steps (4 K1 + 4 K2 p a
   step, no plain call); then flow-SMC from its checkpoint (512
   particles, 8 temperatures, float32: 168 K1 + 164 tiled f32 K2, the
   f32 sampler path); then the f32 K1, K2 and K2 p against their plain
   version at B=512, N=4, a second launch bitwise equal, timed (events
   and device time).
10e. ala2 — alanine dipeptide: ``example/vi_ala2.yaml`` at full width
   (B=256, N=22, nf=4, H=128, float32, the force field on the card) cut to
   1 epoch x FF_STEPS steps (5 f32 K1 + 5 K2 p a step), then
   ``example/sample_ala2.yaml`` as committed from its checkpoint (2048
   particles, 10 temps: 260 f32 K1 + 255 tiled f32 K2, beta 1, the npz's
   dihedrals [2048, 23] and phi/psi profiles with a finite minimum of 0);
   ``example/vi_molecule_ff.yaml`` (N=4, nf=3, H=64) cut the same way (4
   + 4 a step) and its f32 K1 / K2 p against their plain version; then
   the kernel checks: the tiled f32 K2 p must take N >= 22 at nf=4, H=128
   and the tiled f32 K2 N >= 70 at nf=5, H=128 (held against plain at
   N=70), each refusing one atom past its largest, and one atom past
   each tiled limit the f32 block pairs take the molecule
   (against plain, a second launch bitwise equal); then
   the tiled f32 K1, K2 p and K2 against their plain version at B=256,
   N=22, nf=4, H=128 (the K2's dh/dpos also against K2 p's), the K2 also
   at B=2048, a second launch bitwise equal, each timed (events and
   device time) with its bound.
8e. probe — the sampling overflow probe (ROADMAP A5.5):
   ``example/sample_lj13.yaml`` as committed (2048 particles, 10 temps, 1
   x 5 HMC, bf16, H=128) from the LJ13 VI checkpoint with ``nbr_mode:
   topk``: at ``nbr_capacity`` PROBE_CAP monolithic and with
   ``chunk_temps`` PROBE_CHUNK (bitwise equal, the per-stage
   ``nbr_overflow`` column included, one integer a stage summing above 0,
   the truncation warning printed), at PROBE_FULL (= N - 1) a column of
   zeros; every run 5 x (1 + 51 + 10) bf16 K5 and 5 x 51 K6, every one
   on the Hopper kernels (edge_pipeline_sm90.cu's counters; none on any
   other route), no plain call, every output on the card.
   Then ``remc_lj13.yaml`` with the same override cut to PROBE_REMC
   rounds, monolithic and in segments of PROBE_REMC_CHUNK (bitwise equal,
   one probe entry a round, the total on the CSV's last row; every K5/K6
   on the Hopper kernels), and the probe alone timed (CUDA events and the
   host clock) beside the run's seconds.
10h. data — the readers, ``compose`` and the trainer's observability
   (A6, A5.6): ``example/train.yaml`` at full width with ``dataset: {type:
   compose, number: 2}``: ``dataset1`` the committed ``lj`` dataset,
   ``dataset2`` an ``md`` dataset of a ``.gro`` and a ``.trr`` (nm, with
   box and velocities) that ``formats.write_trr`` wrote from
   ``dataset1``'s frames. 2 epochs with ``profile_dir`` and
   ``nan_checks`` (a trace of the second epoch that names the edge
   kernel), then 1 epoch with both off: 2 x 91 samples of one node_nf,
   finite losses, 5 K5 + 5 K6 + 1 K7 r2 a step, s/step with the guard on
   and off. A NaN put into one parameter: the guarded epoch raises
   ``FloatingPointError``, the unguarded one runs. The ``.trr`` and an
   ``.xyz`` of the same frames read through ``largemd``: its length,
   ``max_atoms`` and first sample equal ``md``'s.
10i. import — a reference-layout ``model.cpt`` at train.yaml's width
   (node_nf 1, H=128, 5 networks, ArgMax) from a seeded generator,
   converted by ``python -m enflow_tpu_torch.utils.torch_import``,
   trained 1 epoch of train.yaml on the card (launches as in data), and
   the untrained import exported back by ``python -m
   enflow_tpu_torch.utils.torch_export``: bit for bit the input state
   dict.
11. edge (after dataset, before data) — the gathered-edge EGCL kernels
   (forward K5, backward K6 with
   all seven parameter gradients; bf16 at H = 64/128 the Hopper kernels
   of edge_pipeline_sm90.cu, f32 the tiled kernels of edge_pipeline.cu)
   against their plain version at the training shape (A=390 atoms, K =
   the auto capacity phase 10 observed, C=3, H=128), a ragged one
   (A=1000, K=40, C=11, masked slots and atoms), one whose gate hits the
   clip bounds exactly, one whose row tiles end in padding (K=13), and at
   H=64 and H=96 (zero-padded to 128 by the wrapper's size rule), each
   in bf16 and f32, in bf16 at K=12 (5 atoms a Hopper tile) and K=80
   (atoms spanning two tiles), in f32 at generate.yaml's shape (A=2,944,
   K = phase generate's auto capacity, C=3, H=128, the share of valid
   slots it saw), and in bf16 at the top-k sampler's shape of phase probe
   (A = 2048 x 13, K=8, C=11, H=128), in bf16 at C = 17 and 33 (nf = 8
   and 16: e W1 in two and three k16 steps; H=128 and 64, K=80 at C=33)
   and in f32 at C = 65 (nf = 32: the tiled backward at 8 atoms a tile);
   agg, F_sum, de and dcd within
   TOL_EDGE, the parameter gradients' f32 sums within TOL_PARAM, each
   launch on the kernel the size rule names (its counter), a second K5
   and K6 launch bitwise equal. Timed as in phase 3 at main, ragged,
   generate and sampler, and as device time per launch, the bf16 Hopper
   kernels beside their MUFU and elementwise floors. Last the bf16 K5/K6
   at node_nf 8 (C = 17) through the driver: ``vi_lj13.yaml`` in top-k
   mode (capacity PROBE_FULL) 1 x EDGE_NF8_STEPS steps, then top-k
   ``sample_lj13.yaml`` from its checkpoint, every K5/K6 on the Hopper
   kernels, no plain call.
11b. edge_wide (after edge) — the gathered-edge K5/K6 at 128 < H <= 256
   (W2 and W3 streamed through a ring of slabs: bf16 route ``"wide"`` of
   edge_pipeline_sm90.cu, f32 route ``"f32_wide"`` of edge_pipeline.cu)
   and zero-padded at other widths: (a) ``example/train.yaml`` with
   ``network.hidden_nf: 256`` and nothing else changed through the port's
   driver (its dataset, 2 epochs, then 1 resumed epoch): exactly 5 K5 + 5
   K6 a step on ``f32_wide``, 0 on any other route, no plain call, finite
   losses, a checkpoint; (b) top-k ``vi_lj13.yaml`` (capacity PROBE_FULL)
   at ``hidden_nf: 256``, 1 x EDGE_WIDE_VI_STEPS steps, then top-k
   ``sample_lj13.yaml`` from its checkpoint, every K5/K6 on ``wide``,
   beta 1, finite log_Z; (c) ``train.yaml`` at ``hidden_nf: 96`` for one
   epoch on ``tiled`` and ``padded``; (d) K5/K6 at H = 192, 256, 96 and
   160 at EDGE_WIDE_SHAPES (the training shape, the top-k sampler's in
   bf16 and, at 192 and 256, that of (b)'s SMC run, K = 12;
   generate.yaml's forward in f32, a small batch) against the plain
   version, bf16 read per element (``step_errs``), f32 to TOL_EDGE /
   TOL_PARAM, a second launch bitwise equal, timed (CUDA events, device
   time) beside the bound; the most edge features C each width takes;
   ``edge_round_witness`` at EDGE_WITNESS (20 repeats bitwise equal); the
   plain version at the kernels line's shapes, the padded route's cost
   against H=128 and each driver run's kernel share.
11c. edge_xwide (after edge_wide) — the gathered-edge K5/K6 on the
   column-chunked kernels of edge_pipeline_xwide.cu (routes ``"xwide"``
   and ``"f32_xwide"``: every width past 256, and at 64 .. 256 every C
   that the route of the width does not hold): (a) the library's shared
   memory against the mirror (the same at every H and C); K5/K6 in both
   dtypes at H = 320 and 512 at EDGE_XWIDE_SHAPES (the training, top-k
   and generate shapes, K = 80, a ragged mask) and A = 0, and at the first
   C past each old limit (EDGE_XWIDE_C), against the plain version (bf16
   per element, ``edge_xwide_reading``; f32 to TOL_EDGE / TOL_PARAM), each
   launch on the route ``kernel_for`` names for its C, a second launch
   bitwise equal; (b) K5/K6 timed at EDGE_XWIDE_TIMED (CUDA events, device
   time, the plain version, the bound) and the library's spills; (c)
   ``train.yaml`` at ``hidden_nf: 512`` (2 epochs, 1 resumed: 5 + 5
   ``f32_xwide`` launches a step), top-k ``vi_lj13.yaml`` at 512 (1 x
   EDGE_XWIDE_VI_STEPS) and top-k ``sample_lj13.yaml`` from it cut to
   EDGE_XWIDE_SMC, every K5/K6 on ``xwide``, no plain call, beta 1; each
   run's kernel share.

``python3 chip_smoke.py --ab OLD.cu [OLD.cu ...]`` runs phases 1-2 and then times the
kernels built from OLD.cu against the current ones, alternating old,
new, new, old, old, new in one process. For an earlier
egcl_allpairs_sm90.cu with the same bf16 K1/K2 entry points: the two
sources' one-molecule kernels held to the same bits at the kernel and
params phases' shapes and at each direction's largest molecule, and,
where the earlier source has them, the block-pair kernels at H = 128
(N = 147 and 60) and 64 (N = 100) in every direction, then K1/K2 at the
main-path shape and the SMC run of phase 7. For an earlier
edge_pipeline.cu with the tiled entry points (e.g. ``git show
HEAD~1:enflow_tpu_torch/csrc/edge_pipeline.cu``): f32 K5/K6 held to the
same bits at every EDGE_SHAPES shape of H = 64 or 128, then timed in
turns at the training and ragged shapes (CUDA events and device time)
with one train.yaml epoch each. For an earlier egcl_allpairs_f32.cu: its
one-molecule f32 K1, K2 and K2 p held to the same bits as the current
ones (main, ragged, VI, DW4, ala2 and each largest molecule), and, where
the earlier source has them, its f32 block-pair kernels at H = 128 (N =
147 and 75) and 64 (N = 100) in every direction, then timed in turns.
For an earlier edge_pipeline_sm90.cu with these entry points: bf16
K5/K6 held to the same bits at every EDGE_SHAPES shape of H = 64 or 128
and every EDGE_WIDE_SHAPES shape at 192 and 256 (``edge_ab_shapes``; the
same for edge_pipeline.cu in f32), then timed in turns at the sampler's
shape. For an earlier egcl_allpairs_xwide.cu: the f32 K1, K2 and K2 p
and the bf16 K2 p held to the same bits at H = 320, 512 and 1024 x N =
13, 55 and 147, the bf16 K1 and K2 counted where their bits are the same
and each held to phase xwide (a)'s limits against the plain version;
then K1 / K2 timed in turns at B=1024, N=13, H=512 (both dtypes) and at
B=256, N=55 (bf16).

``python3 chip_smoke.py --blocks-plans`` runs phases 1-2 and then times
the bf16 block-pair kernels at LJ147 (K1 and K2 p at B=256, K2 at
B=1024) with blocks of 16 to 56 atoms (``ops.blocks_plan`` picks 32),
and the f32 block-pair kernels (K1 and K2 p at LJ147, B=256; K2 at LJ561,
B=16) with blocks of 16 to 48 atoms (``ops.f32_blocks_plan``: at most
F32_BLOCK_ATOMS).

``python3 chip_smoke.py --xwide-ablate`` runs phases 1-2 and then times
the bf16 K1 / K2 past H = 256 (the ring kernels, B=1024, N=13, H=512)
beside builds of the same sources with one part removed (XWIDE_ABLATE:
the epilogues, the products, the m1 pass, the paired rounding, the
sigmoid), in turns: what each part costs.

``python3 chip_smoke.py --trace-check ROUNDS MINUTES`` runs phases 1-2 and
then traces 20 K5 launches as ``device_ms`` does, with no margin and with
TRACE_MARGIN_S idle at each end of the window: after the build, after
phases data and import ROUNDS times, and after each of MINUTES idle
minutes; it fails if a trace with the margins lost half the launches.

``python3 chip_smoke.py --edge-seeds FIRST LAST`` runs phases 1-2 and then
holds the bf16 Hopper K5/K6 against their plain version at EDGE_SHAPES
for input seeds FIRST..LAST and prints every reading, then phase
edge_wide's per-element readings (``edge_step_errs``; F_sum and dcd also
at STEP_FLOOR) at EDGE_WIDTHS and H=128 x EDGE_WIDE_SHAPES, each with a
second launch bitwise equal, and ``edge_round_witness`` of every case
over its limits;
``--allpairs-seeds FIRST LAST`` does the same for the bf16 all-pairs K1,
K2 and K2 p at SWEEP_SHAPES and H = 64, 96, 128, 160, 192 and 256, read
per element (``step_errs``) and as TOL / TOL_PARAM read them.
For an earlier pair_energy.cu whose entry point takes no plan (e.g.
``git show 0d49c21:enflow_tpu_torch/csrc/pair_energy.cu``): K7 r at B=1,
N=13, r2 at B=30, N=13 and r at 2,944 atoms (events and device time) and
the MD of one train.yaml dataset.

``python3 chip_smoke.py --profile [FILE]`` runs phases 1-2 and then, in
place of the rest, one warm-up and one SMC run of phase 7 under
``torch.profiler`` tracing device activity only: device time by kernel,
and the device's busy time and idle share of that traced run's wall time
(which includes the tracing's own cost); the full table goes to FILE when
one is given. ``--profile-vi [FILE]`` and ``--profile-train [FILE]`` do
the same for one epoch of phase 8 or 10 after a warm-up epoch, and
``--profile-generate [FILE]`` for generate.yaml's flow (reverse, forward,
reverse) and its MD cut to 1,000 steps, and ``--profile-samplers [FILE]``
for REMC, TI and HMC runs cut to a few rounds or sweeps (PROFILE_SAMPLERS)
and ``sample_ala2.yaml`` as committed.

The last two lines are the kernels' JSON record and
``{"ok": true, "device": {...}}``; the card's name and power limit are
printed on their own line before them.
"""

import argparse
import contextlib
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
# the Hopper kernels at H=64 (bf16; vi_fluid.yaml's width and N), and both
# dtypes at a width the Hopper and tiled f32 kernels do not take (the
# wrapper's size rule)
H64 = dict(B=96, N=32, nf=5, H=64, n_pad=3)
H96 = dict(B=16, N=13, nf=5, H=96, n_pad=1)
# example/vi_lj13.yaml: 512 particles of LJ13 per step
VI = dict(B=512, N=13, nf=5, H=128)
# the same as icosahedra (LJ13's minimum) of a size at which bf16 rounds
# the r2 of each of its four pair distances up by ~2.2e-3 of itself: there
# a rounded r2 shifts every term of dw1r the same way
ICO = dict(VI, ico=1.2455)
# kernel vs plain, max |kernel - plain| / max |plain| per output. The plain
# version rounds where the kernel rounds, so they differ by summation order
# (and, for the bf16 Hopper kernels, by the last f32 bits of SiLU, from
# __expf and __fdividef) only: the sound kernel reads <= 4.4e-7 in f32 and
# <= 2.44e-3 in bf16 (a bf16 ulp at a value that a different order pushed
# across a rounding boundary). Deliberate faults (chip_mutants.py) read far
# above when rows are dropped or mis-masked, and ~6e-3 for one misplaced
# bf16 rounding; the bf16 limit sits between the sound reading and that
# weakest fault.
TOL = {"float32": 1e-4, "bfloat16": 4e-3}
# The same reading for K5/K6 and K7, set from chip_mutants.py. K5/K6 (the
# tiled kernels): the sound kernel reads <= 1.6e-3 in bf16 and <= 1.1e-6
# in f32; a dropped K-sum row reads >= 2.2e-1, the inclusive clip mask 1.7
# (clip shape), a skipped bf16 rounding of dgate >= 6.5e-3 (ragged) and of
# m1 >= 8.5e-3, a padded row counted 1.4e-2 (odd, f32), a block's slice
# unwritten, a prefetch of the wrong rows or a swizzle off by one >= 5.7e-2.
# K5/K6's outputs agg, F_sum, de and dcd are held to TOL_EDGE; their seven
# parameter gradients, compared as the float32 sums before the autograd
# Function rounds them, to TOL_PARAM (chip_mutants.py edge_pipeline_sm90):
# the bf16 Hopper K5/K6 read <= 3.3e-3 on the outputs and <= 2.4e-4 on the
# sums at EDGE_SHAPES' inputs; dgate left unrounded reads 3.7e-3 on the
# outputs (which TOL_EDGE alone would pass) and >= 2.2e-3 on the sums, m1
# rounded toward zero >= 5.3e-3, the bias dropped from pre2's recompute
# >= 8.9e-3, a dropped K-sum row, a stale prefetch, a slice added into
# unwritten memory, an uncleared carry or a column sum in the wrong lane
# >= 0.1. (Over input seeds 13-16, --edge-seeds, 2 of 32 sound readings
# exceed these limits: a bf16 ulp at an output's largest element, when
# one intermediate bf16 rounding on a dominant row goes the other way
# because the tensor cores' f32 sums differ from cuBLAS's; PERF.md.)
# K7: sound <= 8.1e-7; roundf for rintf 7.5e-2, counted d2 = 0 pairs >= 64.
TOL_EDGE = {"float32": 1e-4, "bfloat16": 4e-3}
TOL_PAIR = 1e-4
# The flagged plain EGCL on the card (f32) against the same function at
# float64 on the CPU: f32 round-off of a few H = 128 products (~1e-6).
TOL_FLAGS = 1e-4
# K2's parameter gradients, compared as the float32 sums before the autograd
# Function rounds them (chip_mutants.py egcl_params, faults in the bf16
# Hopper kernel): the sound kernel reads <= 3.4e-4 in bf16 (<= 5.1e-6 in
# f32); a row dropped from dW2's K reads >= 1.7e-2, dz2 unmasked past the
# last row >= 7.6e-3, one slice of partials dropped >= 9.2e-2, the last
# partial tile dropped >= 6.5e-2, dw4 from the rounded dgate 3.4e-3 (vi;
# 6.9e-4 ragged), dw1r from the rounded r2 2.2e-3 (ico; 1.0e-3 ragged;
# 4.9e-4 at the vi shape, which this limit does not see). The bf16 limit
# sits between the sound reading and the weakest fault it must catch,
# 6.9e-4. K5/K6's parameter gradients are held to it the same way.
TOL_PARAM = {"float32": 1e-4, "bfloat16": 6e-4}
# The bf16 all-pairs EGCL at other hidden widths (phase kernel's width
# checks, phase wide, chip_mutants.py egcl_wide) is read per element
# (step_errs), since one bf16 step near an output's largest value, or a
# parameter gradient whose largest value nearly cancels, reads above TOL /
# TOL_PARAM on some input seeds for a sound kernel (--allpairs-seeds).
# An output (agg, f_sum, dh, and dpos, an f32 sum of bf16 values) differs
# from the plain version by its own last rounding and by what a flipped
# intermediate rounding carries into it: its reading is the largest
# |kernel - plain| in bf16 steps of the plain value, values under
# STEP_FLOOR of the output's largest counted at that floor, held to
# STEP_TOL. A parameter gradient (an f32 sum) differs by round-off that
# grows with its terms' magnitudes, not with the sum: its reading is the
# largest |kernel - plain| over TOL_PARAM of the gradient's largest value
# plus TERMS_TOL of the element's terms (allpairs_edges_plain_bwd's
# ``terms``), held to 1. Over 12 input seeds at H = 64, 96, 128, 160,
# 192 and 256 and N = 13 (B=256), 55 and 147 (B=16) (--allpairs-seeds
# 55 66) the sound kernels read at most 2 steps at this floor (6 at a
# floor of 2^-4, 22 at 2^-8: a difference is a share of the output's
# largest value more than of the element) and 0.51 of the parameter
# bound (|diff| at most 2.5e-5 of the terms); TOL / TOL_PARAM's reading
# exceeds its limit at 19 of those 216 cases. Each fault of
# chip_mutants.py egcl_wide reads at least 6 times its limit on every
# line it is caught on.
STEP_TOL = 3.0
STEP_FLOOR = 2.0 ** -2
TERMS_TOL = 2e-5
# Past H = 256 (phase xwide) the bf16 parameter gradients are read against
# a twin of the plain version that keeps its rounding points but sums every
# product in float64 (``plain_f64_twin``), the kernel's and the plain
# version's alike, with the parameter bound above widened by FLIP_TOL x
# the root-sum-square of each gradient's terms (``terms="l2"``). The bound
# above was set from H <= 256, where an f32 sum's round-off flips few bf16
# roundings of z2, z3 and g1. At H = 1024 on a few molecules (N=13, B=8 or
# 16: 1,352 or 2,704 edges) the K-sums flip more of them, and one flip of
# a term near the largest moves a sum by about a bf16 step of that term:
# the plain version (cuBLAS's f32 sums) reads up to 2.7x the bound
# against the twin and the column-chunked kernel 2.8x, both only there
# (PERF.md, section 6). A step in a random direction of every
# term moves a sum by 2^-8 x the root-sum-square; a sum that keeps its
# partials in bf16 (chip_mutants.py xwide's lower-precision mutant) moves
# it by far more. Outputs keep STEP_TOL at every width; on the gathered-edge
# xwide kernels (phase edge_xwide) F_sum and dcd, proportional to the
# gate, an f32 sum of H rounded terms g1_c w4_c, may exceed their steps by
# FLIP_TOL x the root-sum-square of those terms carried through
# (``edge_gate_widen``), the plain version held to the same against its
# f64-summed twin. Over input seeds 61-66 at H = 320 and 512 (the training,
# K = 80 and ragged shapes) the sound kernel read up to 4.00 (F_sum) and
# 5.00 (dcd) bf16 steps at EDGE_GATE_FLOOR against the plain version and
# the same against the twin, the plain version up to 2.00 against the
# twin; the kernel's own m and g1 differ from the plain version's by at
# most one bf16 step (75 and 692 of 844,480 elements at H = 320, ragged,
# seed 61) and given them its sums agree within 0.17 of their bound
# (``edge_round_witness``): rounding flips, not a fault (PERF.md).
FLIP_TOL = 2.0 ** -8


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


def icosahedra(B, scale, gen):
    """``[B, 13, 3]``: LJ13's icosahedron (a centre and 12 vertices at
    ``scale`` from it), randomly rotated per molecule."""
    import torch
    phi = (1.0 + 5.0 ** 0.5) / 2.0
    v = [(0.0, a, b * phi) for a in (-1, 1) for b in (-1, 1)]
    v += [(a, b * phi, 0.0) for a in (-1, 1) for b in (-1, 1)]
    v += [(b * phi, 0.0, a) for a in (-1, 1) for b in (-1, 1)]
    ico = torch.tensor([(0.0, 0.0, 0.0)] + v) * (scale / math.hypot(1, phi))
    rot, _ = torch.linalg.qr(torch.randn((B, 3, 3), generator=gen))
    return ico[None] @ rot


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
        if shape.get("half"):
            # atoms 0 and 1 exactly half a box apart on every axis: the
            # min-image rounding (half to even) sits on its boundary
            q = shape["box"] / 4
            pos[:, 0], pos[:, 1] = -q, q
    elif "ico" in shape:
        pos = icosahedra(B, shape["ico"], gen)
        box = torch.full((B, 3), 1e3, dtype=f32)
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


def work_params(shape, dtype_name, mask):
    """(FLOP, bytes) of the backward with parameter gradients: the
    input-gradient backward's work (``work``) plus, per valid pair, the
    outer products m1^T dz2 and m2^T dz3 (2 H^2 each), r2 dz1 and g1 dgate
    (2 H each) and the three bias sums (H each), and per real atom dW1a =
    h_i^T (sum_j dz1) and dW1b = h_j^T (sum_i dz1) (2 nf H each: both are
    linear in the atom's dz1 summed over its partners, which the kernels
    sum first); bytes plus the nine float32 gradients written once."""
    nf, H = shape["nf"], shape["H"]
    n_real = mask.sum(dim=1).double()
    pairs = float((n_real * (n_real - 1)).sum())
    atoms = float(n_real.sum())
    _, bwd, _, bwd_b = work(shape, dtype_name, mask)
    flop = bwd + pairs * (4 * H * H + 7 * H) + atoms * 2 * 2 * nf * H
    return flop, bwd_b + 4 * (2 * H * H + 2 * nf * H + 5 * H)


def kernel_errs(ops, h, pos, box, mask_f, W, dagg, dfsum):
    """(kernel outputs, {name: (max abs err, relative err)}) of K1 and the
    input-gradient K2 against the plain version on the same inputs."""
    import torch
    k = (ops.allpairs_edges_fwd(h, pos, box, mask_f, W)
         + ops.allpairs_edges_bwd(h, pos, box, mask_f, W, dagg, dfsum))
    p = (ops.allpairs_edges_plain(h, pos, box, mask_f, W)
         + ops.allpairs_edges_plain_bwd(h, pos, box, mask_f, W, dagg, dfsum))
    torch.cuda.synchronize()
    return k, rel_errs(("agg", "f_sum", "dh", "dpos"), k, p)


# The bf16 block-pair kernels (route "blocks") past the one-molecule
# kernels' limits: at the limit + 1 of each direction (B=16, two padded
# atoms), at LJ147 (B=64: 320 work items, so warpgroups walk several and
# add them into one slice) and at N=512 (B=2)
BLOCKS_SHAPES = (("limit+1", dict(B=16, nf=5, H=128, n_pad=2)),
                 ("lj147", dict(B=64, N=147, nf=5, H=128)),
                 ("n512", dict(B=2, N=512, nf=5, H=128)))


def blocks_launches():
    """(block-pair launches {kind: n}, one-molecule launches of any dtype
    and width) since the counts were reset."""
    from enflow_tpu_torch.ops import egcl_allpairs as ea
    c = ea.counts
    one = (c.fwd_launches + c.bwd_launches + c.bwd_f32_launches
           + c.bwd_param_launches)
    return dict(fwd=c.fwd_blocks_launches, bwd=c.bwd_blocks_launches,
                bwd_params=c.bwd_param_blocks_launches), one


def blocks_kernel_checks(largest):
    """Molecules past the one-molecule kernels' shared memory: bf16 K1,
    K2 and K2 p on the block-pair kernels (their own counters, the
    one-molecule counters untouched) against the plain version at
    ``BLOCKS_SHAPES`` (outputs to TOL, the parameter gradients as f32 sums
    to TOL_PARAM), a second launch bitwise equal; a launch the card
    refuses raises."""
    import torch
    from enflow_tpu_torch.ops import egcl_allpairs as ops

    names = {"fwd": ("agg", "f_sum"), "bwd": ("dh", "dpos"),
             "bwd_params": PARAM_OUT}
    bad = []
    for sname, base in BLOCKS_SHAPES:
        for kind in ("fwd", "bwd", "bwd_params"):
            shape = dict(base)
            shape.setdefault("N", largest[f"bf16 {kind}"] + 1)
            h, pos, box, mask_f, W, dagg, dfsum, _ = edge_inputs(
                shape, torch.bfloat16, seed=37)
            args = (h, pos, box, mask_f, W, dagg, dfsum)
            params = kind == "bwd_params"
            run = ((lambda: ops.allpairs_edges_fwd(h, pos, box, mask_f, W))
                   if kind == "fwd" else (lambda p=params:
                                          ops.allpairs_edges_bwd(*args,
                                                                 params=p)))
            ops.counts.reset()
            got = run()
            torch.cuda.synchronize()
            launched, one = blocks_launches()
            plain = (ops.allpairs_edges_plain(h, pos, box, mask_f, W)
                     if kind == "fwd" else ops.allpairs_edges_plain_bwd(
                         *args, params=params))
            errs = rel_errs(names[kind], got, plain)
            del plain
            tol = {n: (TOL_PARAM if n in PARAM_OUT[2:] else TOL)["bfloat16"]
                   for n in names[kind]}
            same = all(bool(torch.equal(a, b)) for a, b in zip(got, run()))
            want = {k: int(k == kind) for k in launched}
            ok = (launched == want and one == 0 and same
                  and all(r <= tol[n] for n, (_, r) in errs.items()))
            phase("kernel", f"blocks {sname} {kind} bf16 B={shape['B']} "
                  f"N={shape['N']}: launches {launched} (one-molecule "
                  f"{one}); max_abs/rel err " + "  ".join(
                      f"{n} {a:.2e}/{r:.1e}" for n, (a, r) in errs.items())
                  + f"; a second launch gives the same bits: {same} -> "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                bad.append((sname, kind))
            torch.cuda.empty_cache()
    require(not bad, f"block-pair kernels disagree with plain: {bad}")
    # a launch that the card refuses raises: a plan of more warpgroups
    # than the kernel takes
    lib = ops._sm90_library()
    shape = dict(B=2, N=147, nf=5, H=128)
    key = (id(lib), 147, 5, 128, "bwd")
    good = ops._blocks_launch_plan(lib, 147, 5, 128, "bwd")
    h, pos, box, mask_f, W, dagg, dfsum, _ = edge_inputs(
        shape, torch.bfloat16, seed=37)
    ops._plans[key] = (32, ops.BLOCK_WG_MAX["bwd"] + 1)
    try:
        ops.allpairs_edges_bwd(h, pos, box, mask_f, W, dagg, dfsum)
    except RuntimeError as e:
        require("launch failed" in str(e) and "blocks" in str(e),
                f"unclear launch failure: {e}")
        phase("kernel", f"blocks: a refused launch raises: {e}")
    else:
        raise RuntimeError("a refused block-pair launch did not raise")
    finally:
        ops._plans[key] = good


# Other hidden widths (phase kernel): bf16 K1, K2 and K2 p at each H of
# WIDTH_HS (zero-padded to 128 or 192, or the streamed widths themselves)
# and each N of WIDTH_NS, B=16 with two padded atoms; f32 at H=96 and
# N=147 (padded to 128, past the tiled f32 K1's limit: on the f32 block
# pairs)
WIDTH_HS = (96, 100, 160, 192, 256)
WIDTH_NS = (13, 55, 147)


def launch_counter(kind, route):
    """The wrapper's counter of one launch of ``kind`` on ``route``."""
    name = {"fwd": "fwd", "bwd": "bwd", "bwd_params": "bwd_param"}[kind]
    if route == "f32" and kind == "bwd":
        name = "bwd_f32"
    if route in ("blocks", "f32_blocks", "wide", "f32_wide", "wide_nf",
                 "f32_wide_nf", "xwide", "f32_xwide"):
        name += "_" + route
    return name + "_launches"


def launched():
    """The all-pairs wrapper's nonzero counters since the last reset."""
    from enflow_tpu_torch.ops import egcl_allpairs as ea
    return {k: v for k, v in vars(ea.counts).items()
            if not k.startswith("_") and v}


def width_checks():
    """The all-pairs EGCL at other hidden widths: bf16 K1, K2 and K2 p at
    each H of WIDTH_HS and N of WIDTH_NS, and f32 at H=96, N=147, each one
    launch on the route the wrapper names (its counter 1,
    ``padded_launches`` 1 where H is padded, every other counter 0)
    against the plain version (bf16 read per element, ``step_errs``; f32
    outputs to TOL, its parameter gradients' sums to TOL_PARAM), a second
    launch bitwise equal."""
    import torch
    from enflow_tpu_torch.ops import egcl_allpairs as ops

    names = {"fwd": ("agg", "f_sum"), "bwd": ("dh", "dpos"),
             "bwd_params": PARAM_OUT}
    cases = [("bfloat16", H, N) for H in WIDTH_HS for N in WIDTH_NS]
    cases.append(("float32", 96, 147))
    bad = []
    for dname, H, N in cases:
        shape = dict(B=16, N=N, nf=5, H=H, n_pad=2)
        h, pos, box, mask_f, W, dagg, dfsum, _ = edge_inputs(
            shape, getattr(torch, dname), seed=H + N)
        args = (h, pos, box, mask_f, W, dagg, dfsum)
        code = 1 if dname == "bfloat16" else 0
        for kind in ("fwd", "bwd", "bwd_params"):
            route = ops._check_fits(code, (16, N, 5, H), kind)
            run = ((lambda: ops.allpairs_edges_fwd(*args[:5]))
                   if kind == "fwd" else (lambda p=kind == "bwd_params":
                                          ops.allpairs_edges_bwd(*args,
                                                                 params=p)))
            ops.counts.reset()
            got = run()
            torch.cuda.synchronize()
            counted = launched()
            want = {launch_counter(kind, route): 1}
            if ops.padded_width(H) != H:
                want["padded_launches"] = 1
            plain = (ops.allpairs_edges_plain(*args[:5]) if kind == "fwd"
                     else ops.allpairs_edges_plain_bwd(
                         *args, params=kind == "bwd_params"))
            if dname == "bfloat16":
                errs = step_errs(names[kind], got, plain, plain_terms(args)
                                 if kind == "bwd_params" else None)
                ok_errs, text = steps_ok(errs), steps_text(errs)
            else:
                errs = rel_errs(names[kind], got, plain)
                ok_errs = all(r <= (TOL_PARAM if n in PARAM_OUT[2:] else
                                    TOL)[dname] for n, (_, r) in errs.items())
                text = "max_abs/rel err " + "  ".join(
                    f"{n} {a:.2e}/{r:.1e}" for n, (a, r) in errs.items())
            del plain
            same = all(bool(torch.equal(a, b)) for a, b in zip(got, run()))
            ok = counted == want and same and ok_errs
            phase("kernel", f"width {dname} H={H} (run at "
                  f"{ops.padded_width(H)}) N={N} B=16 {kind}: route {route}"
                  f", launches {counted}; {text}; a second launch gives the "
                  f"same bits: {same} -> {'ok' if ok else 'FAIL'}")
            if not ok:
                bad.append((dname, H, N, kind))
            del got
        del h, pos, box, mask_f, W, dagg, dfsum, args
        torch.cuda.empty_cache()
    require(not bad, f"other widths disagree with plain: {bad}")


def f32_blocks_shapes():
    """``(name, kind, shape)`` of the f32 block-pair checks at nf=5, H=128:
    one atom past each tiled f32 kernel's limit (N = 143 / 520 / 71; B=16,
    the K2 B=4), LJ147 (B=64) in every direction, and K1 and K2 at N=561
    (B=2, the Mackay icosahedron after 309; phase lj147_f32's (c))."""
    from enflow_tpu_torch.ops import egcl_allpairs as ops
    out = [("limit+1", kind, dict(
        B=4 if kind == "bwd" else 16, n_pad=2, nf=5, H=128,
        N=ops.largest_molecule(0, 5, 128, kind) + 1))
        for kind in ("fwd", "bwd", "bwd_params")]
    out += [("lj147", kind, dict(B=64, N=147, nf=5, H=128))
            for kind in ("fwd", "bwd", "bwd_params")]
    return out + [("n561", kind, dict(B=2, N=561, nf=5, H=128))
                  for kind in ("fwd", "bwd")]


def f32_blocks_launches():
    """(f32 block-pair launches {kind: n}, every other kernel launch of the
    all-pairs wrapper) since the counts were reset."""
    from enflow_tpu_torch.ops import egcl_allpairs as ea
    c = ea.counts
    got = dict(fwd=c.fwd_f32_blocks_launches, bwd=c.bwd_f32_blocks_launches,
               bwd_params=c.bwd_param_f32_blocks_launches)
    every = sum(v for k, v in vars(c).items()
                if k.endswith("_launches"))
    return got, every - sum(got.values())


def f32_blocks_checks():
    """Molecules past the tiled f32 kernels' shared memory: f32 K1, K2 and
    K2 p on the f32 block-pair kernels (their own counters, every other
    counter untouched) against the plain version at ``f32_blocks_shapes``
    (outputs to TOL, the parameter gradients as f32 sums to TOL_PARAM), a
    second launch bitwise equal. A shape within the tiled kernels' limit
    (K2 at N=147) launches the block pairs through
    ``allpairs_edges_blocks``. Returns {(name, kind): max abs err}."""
    import torch
    from enflow_tpu_torch.ops import egcl_allpairs as ops

    names = {"fwd": ("agg", "f_sum"), "bwd": ("dh", "dpos"),
             "bwd_params": PARAM_OUT}
    bad, out = [], {}
    for sname, kind, shape in f32_blocks_shapes():
        h, pos, box, mask_f, W, dagg, dfsum, _ = edge_inputs(
            shape, torch.float32, seed=37)
        args = (h, pos, box, mask_f, W, dagg, dfsum)
        forced = shape["N"] <= ops.largest_molecule(0, 5, 128, kind)
        if forced:
            run = lambda k=kind: ops.allpairs_edges_blocks(  # noqa: E731
                k, *(args[:5] if k == "fwd" else args))
        else:
            run = ((lambda: ops.allpairs_edges_fwd(h, pos, box, mask_f, W))
                   if kind == "fwd" else (lambda p=kind == "bwd_params":
                                          ops.allpairs_edges_bwd(*args,
                                                                 params=p)))
        ops.counts.reset()
        got = run()
        torch.cuda.synchronize()
        launched, other = f32_blocks_launches()
        plain = (ops.allpairs_edges_plain(h, pos, box, mask_f, W)
                 if kind == "fwd" else ops.allpairs_edges_plain_bwd(
                     *args, params=kind == "bwd_params"))
        errs = rel_errs(names[kind], got, plain)
        del plain
        tol = {n: (TOL_PARAM if n in PARAM_OUT[2:] else TOL)["float32"]
               for n in names[kind]}
        same = all(bool(torch.equal(a, b)) for a, b in zip(got, run()))
        want = {k: int(k == kind) for k in launched}
        ok = (launched == want and other == 0 and same
              and all(r <= tol[n] for n, (_, r) in errs.items()))
        A, R = ops._f32_blocks_launch_plan(ops._f32_library(), shape["N"],
                                           5, 128, kind)
        phase("kernel", f"f32 blocks {sname} {kind} B={shape['B']} "
              f"N={shape['N']} (blocks of {A} atoms, {R} rows a row tile"
              + ("; within the tiled limit, launched through "
                 "allpairs_edges_blocks" if forced else "") + "): "
              f"launches {launched} (others {other}); max_abs/rel err "
              + "  ".join(f"{n} {a:.2e}/{r:.1e}" for n, (a, r) in
                          errs.items())
              + f"; a second launch gives the same bits: {same} -> "
              f"{'ok' if ok else 'FAIL'}")
        out[(sname, kind)] = max(a for a, _ in errs.values())
        if not ok:
            bad.append((sname, kind))
        del got, h, pos, box, mask_f, W, dagg, dfsum, args
        torch.cuda.empty_cache()
    require(not bad, f"f32 block-pair kernels disagree with plain: {bad}")
    return out


# the seam: the one-molecule kernels' largest molecule, where both routes
# take it, at these batch sizes
SEAM_B = (64, 1024)


def seam_checks(largest, dname="bfloat16"):
    """The one-molecule and block-pair kernels side by side where both
    take a molecule: N = the one-molecule limit of each direction (nf=5,
    H=128) at ``SEAM_B`` molecules, in bf16 (the Hopper kernels) or f32
    (the tiled f32 kernels). Each on its own counter, their outputs within
    TOL / TOL_PARAM of each other, CUDA events and device time (fewer
    calls where one launch takes ~1 s: f32 K2 at N=519, B=1024). Returns
    {(kind, B): (one-molecule events, device; blocks events, device)}."""
    import torch
    from enflow_tpu_torch.ops import egcl_allpairs as ops

    names = {"fwd": ("agg", "f_sum"), "bwd": ("dh", "dpos"),
             "bwd_params": PARAM_OUT}
    f32 = dname == "float32"
    tag = "f32" if f32 else "bf16"
    out = {}
    for kind in ("fwd", "bwd", "bwd_params"):
        N = largest[f"{tag} {kind}"]
        plan = (ops._f32_blocks_launch_plan(ops._f32_library(), N, 5, 128,
                                            kind) if f32 else
                ops._blocks_launch_plan(ops._sm90_library(), N, 5, 128,
                                        kind))
        for B in SEAM_B:
            heavy = B * N * N > 5e7
            h, pos, box, mask_f, W, dagg, dfsum, _ = edge_inputs(
                dict(B=B, N=N, nf=5, H=128), getattr(torch, dname), seed=43)
            ins = ((h, pos, box, mask_f, W) if kind == "fwd"
                   else (h, pos, box, mask_f, W, dagg, dfsum))
            one = ((lambda: ops.allpairs_edges_fwd(*ins)) if kind == "fwd"
                   else (lambda k=kind: ops.allpairs_edges_bwd(
                       *ins, params=k == "bwd_params")))
            blk = lambda k=kind: ops.allpairs_edges_blocks(k, *ins)
            ops.counts.reset()
            errs = rel_errs(names[kind], blk(), one())
            torch.cuda.synchronize()
            launched, n_one = (f32_blocks_launches() if f32
                               else blocks_launches())
            tol = {n: (TOL_PARAM if n in PARAM_OUT[2:] else TOL)[dname]
                   for n in names[kind]}
            require(launched[kind] == 1 and n_one == 1
                    and all(r <= tol[n] for n, (_, r) in errs.items()),
                    f"seam {kind} {tag} B={B}: launches {launched} + "
                    f"{n_one}, errs {errs}")
            ev = dict(reps=2, calls=1, warmup=1) if heavy else dict(
                reps=10, calls=3)
            dv = dict(calls=2, tries=2, warmup=0) if heavy else {}
            t = (cuda_time_ms(one, **ev),
                 device_ms(one, kernel_key(dname, 128, kind), **dv),
                 cuda_time_ms(blk, **ev),
                 blocks_device_ms(blk, kind, f32, **dv))
            out[(kind, B)] = t
            what = (f"blocks of {plan[0]} atoms, {plan[1]} rows a row tile"
                    if f32 else f"blocks of {plan[0]}, {plan[1]} "
                    "warpgroup(s)")
            phase("kernel", f"seam {kind} {tag} B={B} N={N}: one-molecule "
                  f"events {t[0]:.4f} device {t[1]:.4f} ms | block-pair "
                  f"({what}) events {t[2]:.4f} device {t[3]:.4f} ms | "
                  f"one-molecule / blocks device {t[1] / t[3]:.3f}; outputs "
                  f"apart max rel {max(r for _, r in errs.values()):.1e}")
            del h, pos, box, mask_f, W, dagg, dfsum, ins
            torch.cuda.empty_cache()
    return out


def blocks_plans():
    """The bf16 block-pair kernels at LJ147 (K1 and K2 p at B=256, K2 at
    B=1024) with blocks of 16 to 56 atoms, each at the most warpgroups
    that fit, and the f32 block-pair kernels (K1 and K2 p at LJ147, B=256,
    K2 at LJ561, B=16) with blocks of 16 to 48 atoms, each at the most rows
    a row tile that fit: CUDA events a launch, the wrapper's plan
    marked."""
    import torch
    from enflow_tpu_torch.ops import egcl_allpairs as ops

    lib = ops._sm90_library()
    limit = lib.egcl_sm90_smem_limit()
    for kind, B in (("fwd", LJ147_P), ("bwd_params", LJ147_P),
                    ("bwd", LJ147_K2_BIG)):
        h, pos, box, mask_f, W, dagg, dfsum, _ = edge_inputs(
            dict(B=B, N=LJ147_N, nf=5, H=128), torch.bfloat16, seed=41)
        ins = ((h, pos, box, mask_f, W) if kind == "fwd"
               else (h, pos, box, mask_f, W, dagg, dfsum))
        key = (id(lib), LJ147_N, 5, 128, kind)
        ops._plans.pop(key, None)
        default = ops._blocks_launch_plan(lib, LJ147_N, 5, 128, kind)
        for A in (16, 24, 32, 40, 48, 56):
            nwg = max((n for n in range(1, ops.BLOCK_WG_MAX[kind] + 1)
                       if 0 <= lib.egcl_sm90_blocks_smem_bytes(
                           A, 5, 128, ops._KIND[kind], n) <= limit),
                      default=0)
            if not nwg:
                phase("plans", f"{kind}: blocks of {A} atoms do not fit")
                continue
            ops._plans[key] = (A, nwg)
            ms = cuda_time_ms(lambda: ops.allpairs_edges_blocks(kind, *ins),
                              reps=5, calls=3, warmup=1)
            phase("plans", f"{kind} bf16 B={B} N={LJ147_N}: blocks of {A} "
                  f"atoms, {nwg} warpgroup(s): {ms:.4f} ms"
                  + (" (the wrapper's plan)" if (A, nwg) == default else ""))
        ops._plans[key] = default
        torch.cuda.empty_cache()
    # the f32 block pairs: K1 and K2 p at LJ147 (B=256), K2 at LJ561
    # (B=16), blocks of 16 to 48 atoms with the most rows a row tile that
    # fit beside them
    flib = ops._f32_library()
    limit = flib.egcl_f32_smem_limit()
    for kind, B, N in (("fwd", LJ147_P, LJ147_N),
                       ("bwd_params", LJ147_P, LJ147_N),
                       ("bwd", LJ561_P, LJ561_N)):
        h, pos, box, mask_f, W, dagg, dfsum, _ = edge_inputs(
            dict(B=B, N=N, nf=5, H=128), torch.float32, seed=41)
        ins = ((h, pos, box, mask_f, W) if kind == "fwd"
               else (h, pos, box, mask_f, W, dagg, dfsum))
        key = (id(flib), "f32_blocks", N, 5, 128, kind)
        ops._plans.pop(key, None)
        default = ops._f32_blocks_launch_plan(flib, N, 5, 128, kind)
        for fit in (16, 24, 32, 40, 48):
            rows = next((r for r in range(ops.F32_ROWS_MAX[kind], 7, -8)
                         if 0 <= flib.egcl_f32_blocks_smem_bytes(
                             fit, 5, 128, r, ops._KIND[kind]) <= limit), 0)
            if not rows:
                phase("plans", f"{kind} f32: blocks of {fit} atoms do not "
                      "fit")
                continue
            A = ops.block_atoms(N, fit)
            plan = (A, ops.tile_rows(rows, A * A))
            ops._plans[key] = plan
            ms = cuda_time_ms(lambda: ops.allpairs_edges_blocks(kind, *ins),
                              reps=5, calls=2, warmup=1)
            phase("plans", f"{kind} f32 B={B} N={N}: blocks of {A} atoms, "
                  f"{plan[1]} rows a row tile: {ms:.4f} ms"
                  + (" (the wrapper's plan)" if plan == default else ""))
        ops._plans[key] = default
        del h, pos, box, mask_f, W, dagg, dfsum, ins
        torch.cuda.empty_cache()


def kernel_phase():
    import torch
    from enflow_tpu_torch.ops import egcl_allpairs as ops

    # the largest molecule each one-molecule variant takes at nf=5, H=128;
    # past them each dtype goes to its block-pair kernels
    largest = {f"{dname} {kind}": ops.largest_molecule(code, 5, 128, kind)
               for code, dname in ((1, "bf16"), (0, "f32"))
               for kind in ("fwd", "bwd", "bwd_params")}
    require(min(largest.values()) >= 13, f"LJ13 does not fit: {largest}")
    require(largest["bf16 fwd"] >= 70 and largest["bf16 bwd"] >= 55
            and largest["bf16 bwd_params"] >= 55,
            f"bf16 limits below 70 / 55 / 55 (vi_lj55.yaml): {largest}")
    phase("kernel", "largest N at nf=5, H=128: " + ", ".join(
        f"{k} {v}" for k, v in largest.items()))
    width_checks()
    blocks_kernel_checks(largest)
    f32_errs = f32_blocks_checks()
    seam = seam_checks(largest)
    seam_f32 = seam_checks(largest, "float32")

    large = dict(B=64, N=largest["bf16 bwd"], nf=5, H=128)
    record = {}
    cases = [("main", MAIN, "bfloat16"), ("main", MAIN, "float32"),
             ("ragged", RAGGED, "bfloat16"), ("ragged", RAGGED, "float32"),
             ("large", large, "bfloat16"), ("h64", H64, "bfloat16"),
             ("h96", H96, "bfloat16"), ("h96", H96, "float32")]
    for sname, shape, dname in cases:
        dtype = getattr(torch, dname)
        h, pos, box, mask_f, W, dagg, dfsum, mask = edge_inputs(
            shape, dtype, seed=11)
        ops.counts.reset()
        k_out, errs = kernel_errs(ops, h, pos, box, mask_f, W, dagg, dfsum)
        c = ops.counts
        # f32: the tiled K2 on its own counter; H=96 zero-padded to 128, on
        # the same kernels and on padded_launches too
        tiled = dname == "float32"
        k2, other = ((c.bwd_f32_launches, c.bwd_launches) if tiled
                     else (c.bwd_launches, c.bwd_f32_launches))
        require((c.fwd_launches, k2) == (1, 1) and other == 0
                and c.padded_launches == (
                    2 if sname == "h96" else 0),
                f"{sname} {dname}: launches {vars(c)}")
        ok = all(rel <= TOL[dname] for _, rel in errs.values())
        again, _ = kernel_errs(ops, h, pos, box, mask_f, W, dagg, dfsum)
        same = all(bool(torch.equal(a, b)) for a, b in zip(k_out, again))
        ok = ok and same
        note = f"; a second launch gives the same bits: {same}"
        if sname == "h96":
            note += "; zero-padded to H=128 (1 + 1 padded launches)"
        if tiled:
            note += "; K2 on the tiled f32 kernel"
        phase("kernel", f"{sname} {dname} B={shape['B']} N={shape['N']} "
              f"H={shape['H']} max_abs/rel err: " + "  ".join(
                  f"{n} {a:.3e}/{r:.2e}" for n, (a, r) in errs.items())
              + f"  tol {TOL[dname]:g}{note} -> {'ok' if ok else 'FAIL'}")
        require(ok, f"kernel disagrees with plain ({sname}, {dname})")
        if sname not in ("main", "ragged", "h96"):
            continue

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
        extra, floors = "", None
        if dname == "bfloat16" and sname != "h96":
            floors = {d: v for d, v in sfu_alu_floor(shape, mask).items()
                      if d != "bwd_params"}
            extra = "; MUFU / elementwise floors " + ", ".join(
                f"{d} {a:.4f} / {b:.4f}" for d, (a, b) in floors.items())
        phase("kernel", f"{sname} {dname} time ms: fwd kernel "
              f"{t_k_f:.4f} plain {t_p_f:.4f} bound {bounds['fwd'][0]:.4f}"
              f" ({bounds['fwd'][1]}, {bounds['fwd'][2] / 1e9:.2f} GFLOP)"
              f" | bwd kernel {t_k_b:.4f} plain {t_p_b:.4f} bound "
              f"{bounds['bwd'][0]:.4f} ({bounds['bwd'][1]}, "
              f"{bounds['bwd'][2] / 1e9:.2f} GFLOP){extra}")
        record[(sname, dname)] = dict(
            err_fwd=max(errs["agg"][0], errs["f_sum"][0]),
            err_bwd=max(errs["dh"][0], errs["dpos"][0]),
            ms_fwd=t_k_f, ms_bwd=t_k_b, plain_fwd=t_p_f, plain_bwd=t_p_b,
            bound_fwd=bounds["fwd"], bound_bwd=bounds["bwd"],
            floors=floors)
    return record, largest, dict(bf16=seam, f32=seam_f32, f32_errs=f32_errs)


# Per-SM rates of an H100 SXM (CUDA C Programming Guide, arithmetic
# instruction throughput, compute capability 9.0) at its 1.98 GHz boost
# clock and 132 SMs: MUFU (ex2, rcp) 16 results per clock, FP32 lanes 128
PEAK_MUFU = 16 * 132 * 1.98e9
PEAK_ALU = 128 * 132 * 1.98e9
# elementwise f32/bf16 operations per element of an H-wide activation in
# the bf16 Hopper kernels, counted at the TPU kernel's rounding points (adds,
# products, roundings, the SiLU's scale/add/product, the row dots' fma):
# forward z1 4, m1 4, z2 2, m2 5, z3 2, g1 4 and the gate 1; backward the
# recompute with the SiLU derivatives from the same sigmoids (z1 4, m1 4,
# z2 2, m2 and dsilu(z2) 10, z3 2, g1 and dsilu(z3) 9, gate 1), then dz3 2,
# dz2 4, dz1 14 (z1 and its derivative recomputed) and dr2 1; with
# parameter gradients 6 more: m1 from dsilu(z1)'s sigmoid (a product and a
# rounding) and the outer products' partial adds, 2 H^2 per 64-row tile
# (4 per element at H=128)
ALU_PER_ELEM = {"fwd": 22, "bwd": 53, "bwd_params": 59}
# sigmoids (an ex2 and a rcp each) per element: forward 3; backward 4 (m1,
# m2 with dsilu(z2), g1 with dsilu(z3), dsilu(z1); with parameter
# gradients m1's recompute shares dsilu(z1)'s)
SIGMOIDS = {"fwd": 3, "bwd": 4, "bwd_params": 4}


def sfu_alu_floor(shape, mask):
    """{direction: (MUFU ms, elementwise ms)}: the bf16 Hopper kernels'
    transcendentals and elementwise operations over this input's valid
    pairs at the card's peak rates: the second floor beside the
    tensor-core bound."""
    H = shape["H"]
    n_real = mask.sum(dim=1).double()
    elems = float((n_real * (n_real - 1)).sum()) * H
    return {d: (elems * 2 * SIGMOIDS[d] / PEAK_MUFU * 1e3,
                elems * ALU_PER_ELEM[d] / PEAK_ALU * 1e3)
            for d in SIGMOIDS}


# The same floors for the bf16 Hopper K5/K6 (edge_pipeline_sm90.cu), per
# element of the H-wide activations of a valid slot: sigmoids (an ex2 and
# a rcp each) forward 3, backward 6 (the recompute's 3, then pre3, pre2 and
# pre1 again for the derivatives); elementwise operations at the plain
# version's rounding points, forward 37 (a bias add, torch.sigmoid's expf
# and reciprocal ~9, SiLU's product, the mask and the rounding per layer,
# the gate's fma, the K-sum's add), backward 100 (the recompute, the
# derivative's 4, the chain's products, the column sums' adds and
# shuffles, and the outer products' partial adds, 2 H^2 a 64-row tile)
EDGE_SIGMOIDS = {"fwd": 3, "bwd": 6}
EDGE_ALU_PER_ELEM = {"fwd": 37, "bwd": 100}


def edge_sfu_alu_floor(shape, valid):
    """{direction: (MUFU ms, elementwise ms)} of the bf16 Hopper K5/K6
    over ``valid`` slots at the card's peak rates: the floors beside the
    tensor-core bound."""
    elems = valid * shape["H"]
    return {d: (elems * 2 * EDGE_SIGMOIDS[d] / PEAK_MUFU * 1e3,
                elems * EDGE_ALU_PER_ELEM[d] / PEAK_ALU * 1e3)
            for d in EDGE_SIGMOIDS}


PARAM_OUT = ("dh", "dpos", "dW1a", "dW1b", "dw1r", "db1", "dW2", "db2", "dW3",
             "db3", "dw4")


def param_kernel_phase(large_n):
    """K2 with parameter gradients against its plain version: bf16 (the
    Hopper kernel) at the VI shape (random and icosahedral positions), the
    ragged PBC shape, a large shape (B=64, N = ``large_n``, the bf16
    variant's largest) and H=64; float32 (the tiled f32 kernel) at the
    first three; both dtypes at H=96, which the wrapper zero-pads to 128
    (the same kernels, ``padded_launches``); a second launch of each must
    give the same bits. The
    parameter gradients are compared as the float32 sums both return
    (before the autograd Function rounds them to the weights' dtype);
    dh/dpos also against the input-gradient kernel's on the same inputs.
    Times as in ``kernel_phase`` at the first three shapes, the
    input-gradient variant beside it, and the bf16 MUFU / elementwise
    floors."""
    import torch
    from enflow_tpu_torch.ops import egcl_allpairs as ops

    large = dict(B=64, N=large_n, nf=5, H=128)
    cases = [(sname, shape, dname) for sname, shape in
             (("vi", VI), ("ico", ICO), ("ragged", RAGGED))
             for dname in ("bfloat16", "float32")]
    cases += [("large", large, "bfloat16"), ("h64", H64, "bfloat16"),
              ("h96", H96, "bfloat16"), ("h96", H96, "float32")]
    record, bad = {}, []
    for sname, shape, dname in cases:
        dtype = getattr(torch, dname)
        h, pos, box, mask_f, W, dagg, dfsum, mask = edge_inputs(
            shape, dtype, seed=19)
        args = (h, pos, box, mask_f, W, dagg, dfsum)
        ops.counts.reset()
        k = ops.allpairs_edges_bwd(*args, params=True)
        c = ops.counts
        launches = (c.bwd_param_launches, c.padded_launches)
        p = ops.allpairs_edges_plain_bwd(*args, params=True)
        errs = rel_errs(PARAM_OUT, k, p)
        # dh/dpos of the parameter-gradient variant against the
        # input-gradient kernel's (where it takes the molecule): the same
        # schedule in bf16, two kernels in f32; they agree to TOL (bitwise
        # where the compiler made the same instructions of both)
        vs_in, bitwise, same = {}, None, True
        if shape["N"] <= ops.largest_molecule(1 if dname == "bfloat16"
                                              else 0, 5, shape["H"], "bwd"):
            k_in = ops.allpairs_edges_bwd(*args)
            vs_in = rel_errs(("dh", "dpos"), k[:2], k_in)
            bitwise = all(bool(torch.equal(a, b))
                          for a, b in zip(k[:2], k_in))
            same = all(rel <= TOL[dname] for _, rel in vs_in.values())
        torch.cuda.synchronize()
        tol = {n: (TOL if n in ("dh", "dpos") else TOL_PARAM)[dname]
               for n in PARAM_OUT}
        ok = (all(rel <= tol[n] for n, (_, rel) in errs.items()) and same
              and launches == ((1, 1) if sname == "h96" else (1, 0)))
        again = ops.allpairs_edges_bwd(*args, params=True)
        torch.cuda.synchronize()
        repeat = all(bool(torch.equal(a, b)) for a, b in zip(k, again))
        ok = ok and repeat
        note = f"; a second launch gives the same bits: {repeat}"
        phase("params", f"{sname} {dname} B={shape['B']} N={shape['N']} "
              f"H={shape['H']} launches {launches[0]} ({launches[1]} at a "
              "padded width) max_abs/rel err: " + "  ".join(
                  f"{n} {a:.2e}/{r:.1e}" for n, (a, r) in errs.items())
              + f"  tol dh/dpos {TOL[dname]:g}, parameters "
              f"{TOL_PARAM[dname]:g}; dh/dpos vs the input-gradient "
              "kernel's " + (" ".join(f"{n} {r:.1e}" for n, (_, r) in
                                      vs_in.items())
                             + f" (bitwise {bitwise}; tol {TOL[dname]:g})"
                             if vs_in else "not compared (N beyond its "
                             "limit)") + f"{note} -> {'ok' if ok else 'FAIL'}")
        if not ok:
            bad.append((sname, dname))
        if sname in ("large", "h64"):
            continue
        t_k = cuda_time_ms(lambda: ops.allpairs_edges_bwd(*args,
                                                          params=True))
        t_in = cuda_time_ms(lambda: ops.allpairs_edges_bwd(*args))
        t_p = cuda_time_ms(lambda: ops.allpairs_edges_plain_bwd(
            *args, params=True), reps=20, calls=5)
        flop, nbytes = work_params(shape, dname, mask)
        b = bound(flop, nbytes, PEAK_FLOPS[dname])
        extra, floors = "", None
        if dname == "bfloat16" and sname != "h96":
            floors = sfu_alu_floor(shape, mask)["bwd_params"]
            extra = (f"; MUFU / elementwise floors {floors[0]:.4f} / "
                     f"{floors[1]:.4f}")
        phase("params", f"{sname} {dname} time ms: kernel {t_k:.4f} "
              f"(input-gradient variant {t_in:.4f}) plain {t_p:.4f} "
              f"bound {b[0]:.4f} ({b[1]}, {flop / 1e9:.2f} GFLOP){extra}")
        record[(sname, dname)] = dict(
            err=max(a for a, _ in errs.values()), ms=t_k, ms_input=t_in,
            plain=t_p, bound=b, floors=floors)
    require(not bad, f"parameter-gradient kernel disagrees with plain {bad}")
    return record


def rel_errs(names, got, want):
    """{name: (max |kernel - plain|, that / max |plain|)}; a non-finite
    kernel output reads as an infinite error."""
    import torch
    errs = {}
    for name, k, p in zip(names, got, want):
        require(k.shape == p.shape and k.dtype == p.dtype,
                f"{name}: kernel {tuple(k.shape)}/{k.dtype} vs plain "
                f"{tuple(p.shape)}/{p.dtype}")
        if not bool(torch.isfinite(k).all()):
            errs[name] = (math.inf, math.inf)
            continue
        d = float((k.float() - p.float()).abs().max()) if k.numel() else 0.0
        scale = float(p.float().abs().max()) if p.numel() else 0.0
        errs[name] = (d, d / max(scale, 1e-6))
    return errs


def step_errs(names, got, want, terms=None, floor=STEP_FLOOR, flips=None,
              widen=None):
    """{name: (max |kernel - plain|, reading, its limit)}, read per element
    as set out at STEP_TOL: bf16 steps for an output, the share of its
    bound for a parameter gradient named in ``terms`` ({name: the plain
    sums of its terms' magnitudes}; with ``flips``, {name: the root-sum-
    square of its terms}, the bound grows by FLIP_TOL x that); ``widen``:
    {output name: a per-element amount that |kernel - plain| may exceed
    its steps by}; a non-finite kernel output reads as infinite."""
    import torch
    errs = {}
    for name, k, p in zip(names, got, want):
        require(k.shape == p.shape and k.dtype == p.dtype,
                f"{name}: kernel {tuple(k.shape)}/{k.dtype} vs plain "
                f"{tuple(p.shape)}/{p.dtype}")
        param = bool(terms) and name in terms
        limit = 1.0 if param else STEP_TOL
        if not bool(torch.isfinite(k).all()):
            errs[name] = (math.inf, math.inf, limit)
            continue
        if not k.numel():
            errs[name] = (0.0, 0.0, limit)
            continue
        p = p.float()
        d = (k.float() - p).abs()
        top = float(p.abs().max())
        if param:
            allow = (TOL_PARAM["bfloat16"] * top
                     + TERMS_TOL * terms[name].float().abs())
            if flips:
                allow = allow + FLIP_TOL * flips[name].float()
        else:
            allow = bf16_ulp(p.abs().clamp_min(floor * top))
        over = d if not widen or name not in widen else \
            (d - widen[name].float()).clamp_min(0.0)
        errs[name] = (float(d.max()),
                      float((over / allow.clamp_min(1e-30)).max()), limit)
    return errs


def steps_ok(errs):
    return all(r <= lim for _, r, lim in errs.values())


def steps_text(errs):
    """The readings of ``step_errs``: max |diff| and bf16 steps, or the
    share of the bound (``x``)."""
    return "  ".join(f"{n} {a:.2e}/" + (f"{r:.2f}x" if lim == 1.0 else
                                         f"{r:.2f} steps")
                     for n, (a, r, lim) in errs.items())


def plain_terms(args):
    """{name: the plain sums of each parameter gradient's terms'
    magnitudes} at the inputs ``args`` (step_errs' ``terms``)."""
    from enflow_tpu_torch.ops import egcl_allpairs as ops
    return dict(zip(PARAM_OUT[2:], ops.allpairs_edges_plain_bwd(
        *args, params=True, terms=True)[2:]))


def bound(flop, nbytes, peak):
    """(ms, what bounds it): the larger of operations over the peak rate
    and bytes over the memory rate."""
    t_ops, t_bytes = flop / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


# K5/K6 shapes: the training path's (A = 30 molecules x 13 atoms, K = the
# auto capacity of train.yaml's first frame, 24, which the train phase
# reports and passes in, C = 2 nf + 1 = 3), the top-k sampler's, a ragged
# one (15% of slots and
# some whole atoms masked, C = 11), a small one whose gate is exactly 20 so
# that cd * gate hits the clip bounds +-100 exactly (the strict clip mask
# of the backward, edge_kernel.py:137), one whose row tiles end in padded
# rows (K = 13: 6 atoms a tile, 78 rows; 4 atoms, 52 of 64 rows, on the
# bf16 Hopper kernels), K = 12 and K = 80 (bf16: the Hopper kernels' tiles
# of 5 whole atoms and atoms spanning tiles), and the tiled (f32) and
# Hopper (bf16) kernels at H = 64 and, zero-padded to 128 by the wrapper's
# size rule, at H = 96. These are checked, not timed.
EDGE_SHAPES = {
    "main": dict(A=390, K=24, C=3, H=128, masked=0.2),
    # phase probe's top-k SMC: 2048 particles x 13 atoms, K = 8 of 12
    # neighbours, every slot valid (r_cut 100), nf = 5
    "sampler": dict(A=2048 * 13, K=8, C=11, H=128, masked=0.0,
                    dtypes=("bfloat16",)),
    "ragged": dict(A=1000, K=40, C=11, H=128, masked=0.15, dead=37),
    "clip": dict(A=64, K=8, C=3, H=128, masked=0.1, clip=True),
    "odd": dict(A=777, K=13, C=5, H=128, masked=0.2),
    # the Hopper kernels' tile plan: 5 atoms a tile at K = 12 (60 of 64
    # rows), and atoms that span two tiles (K = 80), K-sums carried
    "k12": dict(A=1000, K=12, C=11, H=128, masked=0.2, dead=20,
                dtypes=("bfloat16",)),
    "k80": dict(A=300, K=80, C=11, H=128, masked=0.2, dead=7,
                dtypes=("bfloat16",)),
    "h64": dict(A=500, K=24, C=3, H=64, masked=0.2),
    "h96": dict(A=200, K=16, C=3, H=96, masked=0.2),
    # C = 2 nf + 1 > 16 (nf = 8 and 16 one-hot features): e W1 in two and
    # three k16 steps of the Hopper kernels, H = 128 and 64 (K = 80: atoms
    # spanning two tiles)
    "c17": dict(A=1000, K=12, C=17, H=128, masked=0.2, dead=20,
                dtypes=("bfloat16",)),
    "c17_h64": dict(A=500, K=24, C=17, H=64, masked=0.2,
                    dtypes=("bfloat16",)),
    "c33": dict(A=300, K=80, C=33, H=128, masked=0.2, dead=7,
                dtypes=("bfloat16",)),
    "c33_h64": dict(A=500, K=24, C=33, H=64, masked=0.2,
                    dtypes=("bfloat16",)),
    # f32 at nf = 32 (C = 65): the tiled backward at 8 atoms a tile
    "c65": dict(A=2944, K=24, C=65, H=128, masked=0.3,
                dtypes=("float32",)),
}
# (k12 beside c17: the same rows at C = 11 and 17)
EDGE_TIMED = ("main", "ragged", "generate", "sampler", "k12", "c17", "c33")
# the f32 shapes timed against an earlier edge_pipeline.cu (--ab)
EDGE_AB = ("main", "ragged")
EDGE_OUT = ("agg", "F_sum", "de", "dcd", "dW1", "db1", "dW2", "db2", "dW3",
            "db3", "dw4")
# K7 shapes: the NLL term of a training batch, the MD potential of the
# dataset's molecule (box 17 A = 5 sigma), a large periodic box, and
# generate.yaml's MD (2,944 atoms in a 100 A box, in sigma, cutoff 3, no
# softening, the MD potential's coincident flag). "r_tie" holds two atoms
# one ulp past half a box of 3.501 apart: the IEEE quotient rounds to
# 0.5 + 2^-24 (the min-image integer 1), a product with the rounded
# reciprocal of the box to 0.5 (integer 0), which flips the pair's force.
PAIR_SHAPES = {
    "r2": dict(form="r2", B=30, N=13, softening=0.1),
    # eight molecules a block (the plan packs molecules of 4 atoms)
    "r2_packed": dict(form="r2", B=30, N=4, softening=0.1),
    "r": dict(form="r", B=1, N=13, softening=0.1, box=5.0, cutoff=3.0),
    "r_large": dict(form="r", B=2, N=1500, n_pad=3, softening=0.1,
                    box=12.0, cutoff=3.0),
    # the MD potential's flag: two coincident atoms count at s > 0
    "r_coincident": dict(form="r", B=1, N=13, softening=0.1, box=5.0,
                         cutoff=3.0, coincident=True),
    "r_tie": dict(form="r", B=1, N=2, softening=0.1, box=3.501, cutoff=3.0,
                  tie=True),
    "r_generate": dict(form="r", B=1, N=2944, softening=0.0, box_ang=100.0,
                       cutoff=3.0, coincident=True, generate=True),
}
# the shapes timed against an earlier pair_energy.cu (--ab)
PAIR_AB = ("r", "r2", "r_generate")


def gathered_inputs(shape, dtype, seed):
    """Gathered edge rows, masks, EGCL edge/coord weights (init_egcl) and
    cotangents on the card for the K5/K6 contract."""
    import torch
    from enflow_tpu_torch.nn.egcl import EGCLConfig, init_egcl

    A, K, C, H = shape["A"], shape["K"], shape["C"], shape["H"]
    nf = (C - 1) // 2
    gen = torch.Generator().manual_seed(seed)
    p = init_egcl(gen, EGCLConfig(nf, H), torch.float32, "cpu")
    W = [p["edge_nn"][0]["w"], p["edge_nn"][0]["b"], p["edge_nn"][1]["w"],
         p["edge_nn"][1]["b"], p["coord_nn"][0]["w"], p["coord_nn"][0]["b"],
         p["coord_nn"][1]["w"]]
    em = torch.rand((A, K), generator=gen) >= shape["masked"]
    if "dead" in shape:
        em[torch.randperm(A, generator=gen)[:shape["dead"]]] = False
    cd = torch.randn((A, K, 3), generator=gen) * 1.5
    if shape.get("clip"):
        # W3 = 0, b3[0] = 20, w4 = e_0: pre3[:, 0] = 20, whose silu is 20
        # exactly in float32, so gate = 20 and cd = +-5 gives +-100
        W[4] = torch.zeros_like(W[4])
        W[5] = torch.zeros_like(W[5])
        W[5][0] = 20.0
        W[6] = torch.zeros_like(W[6])
        W[6][0, 0] = 1.0
        pick = torch.tensor([5.0, -5.0, 10.0, -10.0, 2.0, 0.5])
        cd = pick[torch.randint(0, 6, (A, K, 3), generator=gen)]
    cd = cd * em[..., None]
    h = torch.randn((A, nf), generator=gen)
    nbr = torch.randint(0, A, (A, K), generator=gen)
    e = torch.cat([h[:, None].expand(A, K, nf), h[nbr],
                   (cd * cd).sum(-1, keepdim=True)], dim=-1)
    dagg = torch.randn((A, H), generator=gen)
    dfs = torch.randn((A, 3), generator=gen)
    c = lambda t: t.to(device="cuda", dtype=dtype).contiguous()
    return (c(e), c(cd), c(em), tuple(c(w) for w in W), c(dagg), c(dfs),
            em.cuda())


def edge_work(shape, dtype_name, valid):
    """(fwd FLOP, bwd FLOP, fwd bytes, bwd bytes) of K5/K6 on these rows.
    FLOP per valid row (``valid`` of the A*K slots; a masked slot adds
    nothing to either output, so the function needs none of its work):
    the products at 2 per multiply-add (forward e W1, m1 W2, m W3 and the
    gate 2CH + 4H^2 + 2H; backward that recompute plus dW1, de, dW2, dm1,
    dW3, dm_gate and dw4/dg1, 4CH + 8H^2 + 4H), and about 4 operations
    per SiLU and 8 per SiLU derivative; the K-sums at one add per element.
    Bytes: each input read once (every slot and its mask), each output
    written once."""
    A, K, C, H = shape["A"], shape["K"], shape["C"], shape["H"]
    rows = A * K
    fwd_row = 2 * C * H + 4 * H * H + 2 * H + 3 * 4 * H
    bwd_row = fwd_row + 4 * C * H + 8 * H * H + 4 * H + 3 * (8 * H + 2 * H)
    s = 2 if dtype_name == "bfloat16" else 4
    w = s * (C * H + 2 * H * H + 4 * H)
    ins = s * rows * (C + 3 + 1) + w
    fwd_b = ins + s * A * (H + 3)
    bwd_b = ins + s * A * (H + 3) + s * rows * (C + 3) + w
    return (valid * (fwd_row + H + 3), valid * bwd_row, fwd_b, bwd_b)


def edge_kernel_phase(main_K=None, generate=None):
    """K5/K6 against their plain version at EDGE_SHAPES, bf16 and f32;
    ``main_K`` sets the main shape's slot count, and ``generate`` (A, K,
    C, H and the share of valid slots that phase generate saw) adds
    generate.yaml's shape in f32. A second K5 and K6 launch must give the
    same bits; K5/K6 at EDGE_TIMED timed with CUDA events and as device
    time per launch."""
    import torch
    from enflow_tpu_torch.ops import edge_pipeline as ep

    # the Hopper kernels' reciprocal rounds as torch.sigmoid's division
    t0 = time.perf_counter()
    bad = ep.sm90_recip_mismatches()
    phase("edge", f"the Hopper kernels' sigmoid reciprocal against the "
          f"correctly rounded one at all {126 << 23:,} floats in [1, 2^126): "
          f"{bad} differ ({time.perf_counter() - t0:.2f} s)")
    require(bad == 0, f"{bad} reciprocals round otherwise than __frcp_rn")
    shapes = dict(EDGE_SHAPES)
    if generate:
        shapes["generate"] = dict(
            A=generate["A"], K=generate["capacity"], C=generate["C"],
            H=generate["H"], masked=1.0 - generate["valid"],
            dtypes=("float32",))
    record = {}
    for sname, shape in shapes.items():
        if sname == "main" and main_K:
            shape = dict(shape, K=main_K)
        for dname, dtype in (("bfloat16", torch.bfloat16),
                             ("float32", torch.float32)):
            if dname not in shape.get("dtypes", (dname,)):
                continue
            e, cd, em, W, dagg, dfs, valid = gathered_inputs(shape, dtype,
                                                              seed=13)
            kind = ep.kernel_for(dtype, shape["H"])
            counter = f"{kind}_bwd_launches"
            before = getattr(ep.counts, counter)
            fwd = lambda: ep.edge_pipeline_fwd(e, cd, em, W)
            bwd = lambda: ep.edge_pipeline_bwd(e, cd, em, W, dagg, dfs)
            k = fwd() + bwd()
            again = fwd() + bwd()
            p = (ep.edge_pipeline_plain(e, cd, em, *W)
                 + ep.edge_pipeline_plain_bwd(e, cd, em, *W, dagg, dfs))
            torch.cuda.synchronize()
            require(getattr(ep.counts, counter) == before + 2,
                    f"K6 did not launch on the {kind} kernels")
            errs = rel_errs(EDGE_OUT, k, p)
            tol = {n: (TOL_EDGE if n in EDGE_OUT[:4] else TOL_PARAM)[dname]
                   for n in EDGE_OUT}
            ok = all(errs[n][1] <= tol[n] for n in EDGE_OUT)
            same = all(torch.equal(x, y) for x, y in zip(k, again))
            phase("edge", f"{sname} {dname} A={shape['A']} K={shape['K']} "
                  f"C={shape['C']} H={shape['H']} ({kind}) max_abs/rel err: "
                  + "  ".join(f"{n} {a:.2e}/{r:.1e}"
                              for n, (a, r) in errs.items())
                  + f"  tol {TOL_EDGE[dname]:g} (agg, F_sum, de, dcd), "
                  f"{TOL_PARAM[dname]:g} (parameter gradients, f32 sums) -> "
                  f"{'ok' if ok else 'FAIL'}; second K5 and K6 launch "
                  f"{'bitwise equal' if same else 'DIFFER'}")
            require(ok, f"edge kernel disagrees with plain ({sname}, "
                    f"{dname})")
            require(same, f"a second K5/K6 launch gave other bits ({sname}, "
                    f"{dname})")
            if sname not in EDGE_TIMED:
                continue
            t_kf, t_kb = cuda_time_ms(fwd), cuda_time_ms(bwd)
            d_kf = device_ms(fwd, "fwd_kernel")
            d_kb = device_ms(bwd, "bwd_kernel")
            t_pf = cuda_time_ms(lambda: ep.edge_pipeline_plain(
                e, cd, em, *W), reps=20, calls=5)
            t_pb = cuda_time_ms(lambda: ep.edge_pipeline_plain_bwd(
                e, cd, em, *W, dagg, dfs), reps=20, calls=5)
            fl_f, fl_b, by_f, by_b = edge_work(shape, dname,
                                               int(valid.sum()))
            b_f = bound(fl_f, by_f, PEAK_FLOPS[dname])
            b_b = bound(fl_b, by_b, PEAK_FLOPS[dname])
            floors, extra = None, ""
            if kind == "sm90":
                floors = edge_sfu_alu_floor(shape, int(valid.sum()))
                extra = (f"; MUFU / elementwise floors fwd "
                         f"{floors['fwd'][0]:.4f} / {floors['fwd'][1]:.4f}, "
                         f"bwd {floors['bwd'][0]:.4f} / "
                         f"{floors['bwd'][1]:.4f}")
            phase("edge", f"{sname} {dname} ({kind}) time ms: fwd kernel "
                  f"{t_kf:.4f} (device {d_kf:.4f}) plain {t_pf:.4f} bound "
                  f"{b_f[0]:.4f} ({b_f[1]}, {fl_f / 1e9:.3f} GFLOP) | bwd "
                  f"kernel {t_kb:.4f} (device {d_kb:.4f}) plain {t_pb:.4f} "
                  f"bound {b_b[0]:.4f} ({b_b[1]}, {fl_b / 1e9:.3f} GFLOP)"
                  + extra)
            record[(sname, dname)] = dict(
                err_fwd=max(errs[n][0] for n in EDGE_OUT[:2]),
                err_bwd=max(errs[n][0] for n in EDGE_OUT[2:]),
                ms_fwd=t_kf, ms_bwd=t_kb, dev_fwd=d_kf, dev_bwd=d_kb,
                plain_fwd=t_pf, plain_bwd=t_pb, bound_fwd=b_f, bound_bwd=b_b,
                floors=floors)
    record["nf8"] = edge_nf8_path()
    return record


EDGE_NF8_STEPS = 3


def edge_nf8_path():
    """The bf16 gathered-edge EGCL at 8 node features (C = 17, two k16
    steps of e W1) through the port's driver: ``vi_lj13.yaml`` with
    ``network.node_nf: 8`` in top-k mode (``nbr_capacity`` PROBE_FULL, as
    phase probe's exact run), 1 epoch x EDGE_NF8_STEPS steps (5 K5 + 5 K6
    a step), then top-k ``sample_lj13.yaml`` at the same width from its
    checkpoint (5 x (1 + value-and-grads + temperatures) K5, 5 x
    value-and-grads K6). Every K5/K6 on the Hopper kernels, no plain call,
    finite losses, beta 1, outputs on the card. Returns the launches."""
    import os
    import torch

    net = dict(hidden_nf=128, node_nf=8)
    dyn = dict(nbr_mode="topk", nbr_capacity=PROBE_FULL, network=net,
               checkpoint_path="lj13_nf8.cpt")
    cwd = os.getcwd()
    try:
        with tempfile.TemporaryDirectory() as tmp:
            vi = config_driver(tmp, "vi_lj13.yaml", over=dict(
                num_epochs=1, steps_per_epoch=EDGE_NF8_STEPS), dynamics=dyn)
            step_s, losses = time_vi_steps(vi)
            reset_counts()
            vi.train()
            torch.cuda.synchronize()
            got_vi, routes_vi = edge_launches(), edge_routes()
            n = vi.n_iter * EDGE_NF8_STEPS
            want = dict(k5=n, k6=n, allpairs=0, plain=0)
            require(got_vi == want and routes_vi == route_counts("sm90", n, n),
                    f"nf=8 VI launches {got_vi} by kernel {routes_vi}")
            require(len(losses) == EDGE_NF8_STEPS
                    and all(math.isfinite(x) for x in losses),
                    f"nf=8 VI losses {losses}")
            smc = config_driver(tmp, "sample_lj13.yaml", over=dict(
                output="lj13_nf8_samples.npz",
                metrics_csv="lj13_nf8_smc.csv"), dynamics=dyn)
            sec = smc.args["sampling"]
            reset_counts()
            res, secs = timed_sample(smc)
            got, routes = edge_launches(), edge_routes()
            T = sec["n_temps"]
            n_vg = 1 + T * sec["mcmc_steps"] * sec["n_leapfrog"]
            want = dict(k5=smc.n_iter * (1 + n_vg + T),
                        k6=smc.n_iter * n_vg, allpairs=0, plain=0)
            require(got == want and routes == route_counts(
                "sm90", want["k5"], want["k6"]),
                f"nf=8 SMC launches {got} by kernel {routes} != {want}")
            P = sec["n_particles"]
            check_smc(res, "nf=8 top-k SMC", P, 13)
            require(on_card(res.particles) and res.log_weights.is_cuda,
                    "nf=8 SMC outputs not on the card")
            phase("edge", f"node_nf 8 (C=17) through the driver on the "
                  f"Hopper kernels: vi_lj13.yaml top-k (capacity "
                  f"{PROBE_FULL}) 1 x {EDGE_NF8_STEPS} steps, "
                  f"{statistics.median(step_s[1:]):.5f} s/step, losses "
                  + ", ".join(f"{x:.2f}" for x in losses)
                  + f", K5/K6 {routes_vi['sm90']}; sample_lj13.yaml top-k "
                  f"from its checkpoint: {P} particles x {T} temps "
                  f"{secs:.3f} s, log_Z {float(res.log_Z):.4f}, beta "
                  f"{float(res.beta_history[-1]):.6f}, K5/K6 "
                  f"{routes['sm90']} (Hopper), other routes 0, plain 0")
            del vi, smc, res
    finally:
        os.chdir(cwd)
    return dict(vi=got_vi, smc=got)


# Phase edge_wide: the gathered-edge K5/K6 at 128 < H <= 256 (routes "wide",
# bf16, and "f32_wide", W2 / W3 streamed) and zero-padded at other widths.
# (a) train.yaml and (b) the top-k LJ13 pair run at EDGE_WIDE_H, (c)
# train.yaml at EDGE_PADDED_H; (d) each kernel against the plain version at
# EDGE_WIDTHS and EDGE_WIDE_SHAPES: the training shape (its K the
# capacity (a) saw), the top-k sampler's (K = 8 of LJ13's 12 neighbours),
# the shape of (b)'s top-k SMC run ("topk": K = 12 = PROBE_FULL, 5 atoms
# and 4 padded rows a 64-row bf16 tile where K = 8 fills a tile with 8
# atoms; at the kernels' own widths, where (b) runs), generate.yaml's
# forward (its K and valid share those phase generate saw) and a small
# batch ("small": one atom a block, one 8-row f32 tile, 16 bf16 tiles),
# where a slab's products are shortest and the next slab's copy is least
# hidden. A shape's ``widths`` limits the widths it is read at.
EDGE_WIDE_H = 256
EDGE_PADDED_H = 96
EDGE_WIDE_VI_STEPS = 3
EDGE_WIDTHS = (192, 256, 96, 160)
EDGE_WIDE_SHAPES = {
    "train": dict(A=390, K=24, C=3, masked=0.2),
    "sampler": dict(A=2048 * 13, K=8, C=11, masked=0.0,
                    dtypes=("bfloat16",)),
    "topk": dict(A=2048 * 13, K=12, C=11, masked=0.0, dtypes=("bfloat16",),
                 widths=(192, 256)),
    "generate": dict(A=2944, K=56, C=3, masked=0.5, dtypes=("float32",),
                     fwd_only=True),
    "small": dict(A=128, K=8, C=11, masked=0.2),
}


def route_counts(route, k5, k6, padded=False):
    """``edge_routes()`` of a run whose K5/K6 all went to ``route`` (and,
    ``padded``, all at a padded width)."""
    from enflow_tpu_torch.ops import edge_pipeline as ep
    out = {r: (0, 0) for r in ep.ROUTES + ("padded",)}
    out[route] = (k5, k6)
    if padded:
        out["padded"] = (k5, k6)
    return out


def edge_c_limits():
    """{"dtype H=.. direction": the most edge features C} that K5/K6 take
    at H = 128 and each width of EDGE_WIDTHS, launched at its padded width,
    from the libraries' size entry points: bf16 the Hopper kernels (a
    block of one warpgroup fits), f32 the tiled kernels at 1 atom and 8
    rows a tile (ROADMAP B7.3)."""
    from enflow_tpu_torch.ops import edge_pipeline as ep
    lib, slib = ep._library(), ep._sm90_library()
    limit = lib.edge_pipeline_smem_limit()
    out = {}
    for H in (128,) + EDGE_WIDTHS:
        Hp = ep.padded_width(H)
        for bwd, d in ((0, "fwd"), (1, "bwd")):
            out[f"bf16 H={H} {d}"] = max(
                (C for C in range(1, slib.edge_sm90_c_max() + 1)
                 if slib.edge_sm90_warpgroups(C, Hp, bwd) >= 1), default=0)
            out[f"f32 H={H} {d}"] = max(
                (C for C in range(1, 1025)
                 if 0 <= lib.edge_tiled_smem_bytes(0, C, Hp, 1, 8, bwd)
                 <= limit), default=0)
    return out


def edge_wide_train(card, H, epochs, resume, tmp, checkpoint):
    """train.yaml at ``hidden_nf: H`` through the port's driver in ``tmp``
    (the dataset simulated there on the first call, read back on later
    ones): ``epochs`` epochs, then with ``resume`` 1 more that resumes
    from the checkpoint. Every K5/K6 on the route the size rule names
    (padded below 256 where H is not a kernel width), 5 + 5 a step, one K7
    r2 a step, no plain call, finite losses. Returns s/step, the
    launches, the capacity."""
    import torch
    from enflow_tpu_torch.ops import edge_pipeline as ep
    net = dict(network=dict(hidden_nf=H), checkpoint_path=checkpoint)
    main = config_driver(tmp, "train.yaml", over=dict(num_epochs=epochs),
                         dynamics=net)
    require(main.hidden_nf == H, f"hidden_nf {main.hidden_nf} != {H}")
    cap = main.flow_cfg.nbr_capacity
    reset_counts()
    step_s, losses = timed_train(main)
    got, routes = train_launches(), edge_routes()
    n = len(step_s)
    route = ep.kernel_for(torch.float32, H)
    padded = ep.padded_width(H) != H
    require(n == epochs * TRAIN_STEPS_PER_EPOCH and got == want_train(n)
            and routes == route_counts(route, 5 * n, 5 * n, padded),
            f"train.yaml H={H}: {n} steps, launches {got} by kernel "
            f"{routes}")
    require(all(math.isfinite(x) for x in losses),
            f"non-finite train.yaml H={H} losses {losses}")
    require(Path(checkpoint).exists(), f"no checkpoint {checkpoint}")
    out = dict(step_s=step_s, losses=losses, launches=routes[route],
               capacity=cap, route=route)
    if resume:
        again = config_driver(tmp, "train.yaml", over=dict(num_epochs=1),
                              dynamics=net)
        require(again.start_epoch == epochs, f"H={H} rerun did not resume "
                f"at epoch {epochs} (start {again.start_epoch})")
        reset_counts()
        s2, l2 = timed_train(again)
        routes2 = edge_routes()
        n2 = len(s2)
        require(n2 == TRAIN_STEPS_PER_EPOCH and routes2 == route_counts(
            route, 5 * n2, 5 * n2, padded) and plain_calls() == 0
            and all(math.isfinite(x) for x in l2),
            f"train.yaml H={H} resumed epoch: {n2} steps, {routes2}, "
            f"losses {l2}")
        out.update(resumed=routes2[route], resumed_losses=l2)
    return out


def topk_vi_sample(card, ph, H, route, steps, smc_over=None):
    """Top-k ``vi_lj13.yaml`` (capacity PROBE_FULL) at ``hidden_nf`` H, 1 x
    ``steps`` steps, then top-k ``sample_lj13.yaml`` from its checkpoint
    (``smc_over``: its sampling section's cuts), in a fresh temporary
    directory: every K5/K6 on ``route``, launches held exactly, no plain
    call, finite losses, beta 1 and a finite log_Z, outputs on the card.
    Returns {"vi": ..., "smc": ...}."""
    import os
    import torch

    cwd = os.getcwd()
    out = {}
    try:
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            net = dict(hidden_nf=H, node_nf=5)
            dyn = dict(nbr_mode="topk", nbr_capacity=PROBE_FULL, network=net,
                       checkpoint_path="lj13_w.cpt")
            vi = config_driver(tmp, "vi_lj13.yaml", over=dict(
                num_epochs=1, steps_per_epoch=steps), dynamics=dyn)
            step_s, losses = time_vi_steps(vi)
            reset_counts()
            vi.train()
            torch.cuda.synchronize()
            got_vi, routes_vi = edge_launches(), edge_routes()
            n = vi.n_iter * steps
            require(got_vi == dict(k5=n, k6=n, allpairs=0, plain=0)
                    and routes_vi == route_counts(route, n, n),
                    f"H={H} top-k VI launches {got_vi} by kernel "
                    f"{routes_vi}")
            require(len(losses) == steps
                    and all(math.isfinite(x) for x in losses),
                    f"H={H} VI losses {losses}")
            smc = config_driver(tmp, "sample_lj13.yaml", over=dict(
                smc_over or {}, output="lj13_w.npz",
                metrics_csv="lj13_w_smc.csv"), dynamics=dyn)
            sec = smc.args["sampling"]
            reset_counts()
            res, secs = timed_sample(smc)
            got, routes = edge_launches(), edge_routes()
            T = sec["n_temps"]
            n_vg = 1 + T * sec["mcmc_steps"] * sec["n_leapfrog"]
            want = dict(k5=smc.n_iter * (1 + n_vg + T), k6=smc.n_iter * n_vg,
                        allpairs=0, plain=0)
            require(got == want and routes == route_counts(
                route, want["k5"], want["k6"]),
                f"H={H} top-k SMC launches {got} by kernel {routes} != "
                f"{want}")
            P = sec["n_particles"]
            check_smc(res, f"H={H} top-k SMC", P, 13)
            require(on_card(res.particles) and res.log_weights.is_cuda,
                    f"H={H} SMC outputs not on the card")
            out["vi"] = dict(s_step=statistics.median(step_s[1:]),
                             launches=routes_vi[route])
            out["smc"] = dict(secs=secs, launches=routes[route], P=P, T=T)
            phase(ph, f"vi_lj13.yaml top-k (capacity {PROBE_FULL}) at "
                  f"hidden_nf {H} on {card}: 1 x {steps} steps of "
                  f"{vi.vi_particles} particles, {out['vi']['s_step']:.5f} "
                  f"s/step, losses " + ", ".join(f"{x:.2f}" for x in losses)
                  + f", K5/K6 {routes_vi[route]} on {route}; "
                  f"sample_lj13.yaml top-k from its checkpoint: {P} "
                  f"particles x {T} temps {secs:.3f} s, log_Z "
                  f"{float(res.log_Z):.4f}, beta "
                  f"{float(res.beta_history[-1]):.6f}, K5/K6 "
                  f"{routes[route]} on {route}, 0 on any other route, plain "
                  f"0 ({time.perf_counter() - t0:.1f} s)")
            del vi, smc, res
    finally:
        os.chdir(cwd)
    torch.cuda.empty_cache()
    return out


def edge_wide_paths(card):
    """Phase edge_wide's driver paths: (a) train.yaml at hidden_nf
    EDGE_WIDE_H, 2 epochs then 1 resumed, on ``f32_wide``; (b) top-k
    vi_lj13.yaml at EDGE_WIDE_H (capacity PROBE_FULL), 1 x
    EDGE_WIDE_VI_STEPS steps, then top-k sample_lj13.yaml from its
    checkpoint, on ``wide``; (c) train.yaml at EDGE_PADDED_H for 1 epoch
    on ``tiled`` and ``padded``. Launches held exactly, no plain call,
    finite losses, beta 1 and a finite log_Z, outputs on the card."""
    import os
    import torch

    cwd = os.getcwd()
    out = {}
    try:
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            a = edge_wide_train(card, EDGE_WIDE_H, 2, True, tmp,
                                "model_w.cpt")
            out["train"] = a
            later = a["step_s"][TRAIN_STEPS_PER_EPOCH:]
            a["s_step"] = statistics.median(later)
            phase("edge_wide", f"(a) train.yaml at hidden_nf {EDGE_WIDE_H} "
                  f"on {card}: auto capacity {a['capacity']}, 2 epochs x "
                  f"{TRAIN_STEPS_PER_EPOCH} steps, {a['s_step']:.5f} s/step "
                  f"(median of epoch 2; first step {a['step_s'][0]:.4f} s), "
                  f"losses " + ", ".join(f"{x:.2f}" for x in a["losses"])
                  + f"; K5/K6 {a['launches']} on f32_wide (5 + 5 a step), "
                  f"0 on any other route, plain 0; resumed epoch 3: K5/K6 "
                  f"{a['resumed']}, losses " + ", ".join(
                      f"{x:.2f}" for x in a["resumed_losses"])
                  + f" ({time.perf_counter() - t0:.1f} s with the dataset)")
            t0 = time.perf_counter()
            c = edge_wide_train(card, EDGE_PADDED_H, 1, False, tmp,
                                "model_p.cpt")
            c["s_step"] = statistics.median(c["step_s"][1:])
            out["padded"] = c
            phase("edge_wide", f"(c) train.yaml at hidden_nf "
                  f"{EDGE_PADDED_H} (zero-padded to 128) on {card}: 1 epoch, "
                  f"{c['s_step']:.5f} s/step, losses " + ", ".join(
                      f"{x:.2f}" for x in c["losses"])
                  + f"; K5/K6 {c['launches']} on tiled and padded, plain 0 "
                  f"({time.perf_counter() - t0:.1f} s)")
    finally:
        os.chdir(cwd)
    out.update(topk_vi_sample(card, "edge_wide", EDGE_WIDE_H, "wide",
                              EDGE_WIDE_VI_STEPS))
    torch.cuda.empty_cache()
    return out


# K5/K6's F_sum and dcd are proportional to the gate, an f32 sum of H
# rounded bf16 terms: where the kernel's and cuBLAS's sums round an
# intermediate (m, g1) the other way, the gate moves by a share of its
# scale, not of the element. So phase edge_wide reads them per element at
# a floor of half their largest value. Over input seeds 61-68 at H = 96,
# 128, 160, 192, 256 and EDGE_WIDE_SHAPES the sound bf16 kernels read at
# most 3.00 bf16 steps there (5.62 at STEP_FLOOR; dcd, H=192, K = 12), agg
# and de at most 2; the parameter gradients at most 0.7 of their bound
# but for one case, 6.2 (H=256, the small batch, seed 65), whose cause
# edge_round_witness reads out (PERF.md).
EDGE_GATE_FLOOR = 2.0 ** -1


def edge_step_errs(names, got, want, terms=None, widen=None):
    """``step_errs`` of K5/K6 outputs, F_sum and dcd at EDGE_GATE_FLOOR
    (``widen``: step_errs' widening of those two)."""
    errs = step_errs(names, got, want, terms)
    gate = [i for i, n in enumerate(names) if n in ("F_sum", "dcd")]
    errs.update(step_errs([names[i] for i in gate], [got[i] for i in gate],
                          [want[i] for i in gate], floor=EDGE_GATE_FLOOR,
                          widen=widen))
    return errs


def edge_plain_sums(e, cd, em, W, dagg, dfs, mag=False, given=None,
                    acc=None):
    """K6's seven parameter gradients as ``edge_pipeline_plain_bwd``
    computes them (its steps restated here to reach them), as {name: f32
    sum}; with ``mag`` each is the sum of its terms' magnitudes (``|a|^T
    |b|``: step_errs' ``terms``), with ``mag="l2"`` the sum of their
    squares. ``given``: {"m" and / or "g1": a bf16 [A, K, H] tensor} taken
    in place of that rounded intermediate. ``acc``: the dtype every
    product and sum is taken in (float32 by default; the rounding points
    stay where they are)."""
    import torch
    from enflow_tpu_torch.ops import edge_pipeline as ep
    given = given or {}
    acc = acc or torch.float32
    dt, f = e.dtype, (lambda t: t.to(acc))
    rnd = lambda name, t: f(given.get(name, t.to(dt)))
    W1, b1, W2, b2, W3, b3, w4 = (f(w) for w in W)
    silu, dsilu = ep._silu, ep._dsilu
    emf = f(em.to(dt))[..., None]
    pre1 = f(e) @ W1 + b1
    m1 = rnd("m1", silu(pre1))
    pre2 = m1 @ W2 + b2
    m = rnd("m", silu(pre2) * emf)
    pre3 = m @ W3 + b3
    g1 = rnd("g1", silu(pre3))
    gate = g1 @ w4
    cdf = f(cd)
    dtr = f(dfs.to(dt))[:, None, :]
    pre_tr = cdf * gate
    dtr = dtr * ((pre_tr > -100.0) & (pre_tr < 100.0)).float() * emf
    dgate = rnd("dgate", (cdf * dtr).sum(-1, keepdim=True))
    dpre3 = (dgate @ w4.T) * dsilu(pre3)
    dpre2 = (f(dagg.to(dt))[:, None, :] + rnd("dpre3", dpre3) @ W3.T) \
        * emf * dsilu(pre2)
    dpre1 = (rnd("dpre2", dpre2) @ W2.T) * dsilu(pre1)
    flat = lambda t: (t.square() if mag == "l2" else t.abs() if mag
                      else t).reshape(-1, t.shape[-1])
    outer = lambda a, b: flat(a).T @ flat(b)
    return dict(dW1=outer(f(e), rnd("dpre1", dpre1)), db1=flat(dpre1).sum(0),
                dW2=outer(m1, rnd("dpre2", dpre2)), db2=flat(dpre2).sum(0),
                dW3=outer(m, rnd("dpre3", dpre3)), db3=flat(dpre3).sum(0),
                dw4=outer(g1, dgate))


def edge_wide_terms(e, cd, em, W, dagg, dfs):
    """{name: the plain sums of each K6 parameter gradient's terms'
    magnitudes} (step_errs' ``terms``)."""
    return edge_plain_sums(e, cd, em, W, dagg, dfs, mag=True)


# the witness of a bf16 K6 reading over its limit (edge_round_witness):
# the repeated launches (half of them beside a stream of 1 GiB copies), and
# (seed, H, shape) of the one case over its limit in the seed sweep
WITNESS_REPEATS = 20
EDGE_WITNESS = (65, 256, "small")
# the most edges whose g1 the witness reads out (one K6 launch an edge)
WITNESS_EDGES = 4096


def edge_round_witness(seed, H, sname, repeats=WITNESS_REPEATS):
    """Why the bf16 K6 at (``sname``, ``H``, input ``seed``) reads what it
    reads against the plain version. ``repeats`` more launches, half of
    them beside a stream of copies that delays the ring's slab copies,
    bitwise equal to the first. The kernel's own rounded m and g1, read
    out of launches that leave one term in a sum: m from K5's agg with one
    slot of each atom valid (K launches), g1 from K6's dw4 with one edge's
    cd nonzero (one launch an edge with a nonzero dgate); each against the
    plain version's: how many elements differ, by how many bf16 steps,
    and how near a rounding tie the plain f32 value of each lies. Then
    the kernel against the plain version given the kernel's m and g1. And
    both against the float64 plain version on the same bf16 inputs
    (nothing rounded in between). Returns the readings."""
    import torch
    from enflow_tpu_torch.ops import edge_pipeline as ep

    shape = dict(EDGE_WIDE_SHAPES[sname], H=H)
    e, cd, em, W, dagg, dfs, _ = gathered_inputs(shape, torch.bfloat16, seed)
    args = (e, cd, em, W, dagg, dfs)
    A, K = em.shape
    bwd = lambda *a: ep.edge_pipeline_bwd(*a)[2:]
    k = bwd(*args)
    big = torch.empty(2 ** 28, device="cuda")
    dst, side = torch.empty_like(big), torch.cuda.Stream()
    same = True
    for i in range(repeats):
        if i % 2:
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                for _ in range(10):
                    dst.copy_(big)
        same &= all(torch.equal(x, y) for x, y in zip(k, bwd(*args)))
    torch.cuda.synchronize()
    del big, dst
    names = EDGE_OUT[4:]
    terms = edge_wide_terms(*args)
    worst = lambda got, want: max(r for _, r, _ in step_errs(
        names, got, [want[n] for n in names], terms).values())
    plain = edge_plain_sums(*args)
    # the plain intermediates and the kernel's
    emf, *_, m, _, g1, gate = ep._recompute(e, em, *W)
    pre_tr = cd.float() * gate
    clip = ((pre_tr > -100.0) & (pre_tr < 100.0)).float()
    dgate = (cd.float() * (dfs.float()[:, None, :] * clip * emf)).sum(-1)
    dgate = dgate.to(torch.bfloat16).float()
    m_k = torch.empty_like(m)
    for s in range(K):
        one = torch.zeros_like(em)
        one[:, s] = em[:, s]
        m_k[:, s] = ep.edge_pipeline_fwd(e, cd, one, W)[0]
    g1_k = g1.clone()
    for i in dgate.reshape(-1).nonzero()[:, 0].tolist():
        a, s = divmod(i, K)
        one = torch.zeros_like(cd)
        one[a, s] = cd[a, s]
        dw4 = ep.edge_pipeline_bwd(e, one, em, W, dagg, dfs)[8][:, 0]
        g1_k[a, s] = (dw4 / dgate[a, s]).to(torch.bfloat16)
    torch.cuda.synchronize()

    def compare(mine, theirs):
        """(elements that differ, the most bf16 steps between the two,
        values under STEP_FLOOR of the largest counted at that floor)"""
        a, b = mine.float(), theirs.float()
        top = float(b.abs().max())
        steps = (a - b).abs() / bf16_ulp(b.abs().clamp_min(STEP_FLOOR * top))
        return int((a != b).sum()), float(steps.max())

    cm, cg = compare(m_k, m), compare(g1_k, g1)
    mine = worst(k, edge_plain_sums(*args, given=dict(m=m_k, g1=g1_k)))
    # the largest term of dw4's worst element (kernel vs plain)
    j = int(((k[6] - plain["dw4"]).abs()
             / (TOL_PARAM["bfloat16"] * plain["dw4"].abs().max()
                + TERMS_TOL * terms["dw4"])).argmax())
    t = (g1[..., j].float() * dgate).abs().reshape(-1)
    row = int(t.argmax())
    d = lambda t: t.double()
    exact = dict(zip(names, (t.float() for t in ep.edge_pipeline_plain_bwd(
        d(e), d(cd), em, *(d(w) for w in W), d(dagg), d(dfs))[2:])))
    out = dict(same=same, kernel=worst(k, plain), given=mine, m=cm, g1=cg,
               exact=(worst(k, exact), worst([plain[n] for n in names],
                                             exact)))
    differ = lambda c: (f"{c[0]} of {m.numel()} differ, by at most "
                        f"{c[1]:.2f} bf16 steps (at STEP_FLOOR)")
    phase("edge-witness", f"H={H} {sname} bfloat16 seed {seed}: {repeats} "
          f"more K6 launches (half beside a copy stream) "
          f"{'bitwise equal' if same else 'DIFFER'}; kernel vs plain "
          f"{out['kernel']:.2f}x its bound; the kernel's own m: "
          f"{differ(cm)}; its g1: {differ(cg)}; kernel vs the plain version "
          f"given the kernel's m and g1 {mine:.2f}x; vs float64 with "
          f"nothing rounded: kernel {out['exact'][0]:.2f}x, plain "
          f"{out['exact'][1]:.2f}x; dw4's worst element {j}: its largest "
          f"term (atom {row // K}, slot {row % K}) "
          f"{float(t[row] / t.sum()):.1%} of its terms' magnitudes")
    return out


def edge_wide_checks(train_K, generate=None):
    """(d): K5/K6 at each width of EDGE_WIDTHS and shape of
    EDGE_WIDE_SHAPES against the plain version, one launch each on the
    route the size rule names (and ``padded_*`` where padded), read per
    element (``edge_step_errs``) in bf16 and to TOL_EDGE / TOL_PARAM in f32, a
    second launch bitwise equal, timed with CUDA events and as device time
    beside the bound (``edge_work``). Returns the readings and times."""
    import torch
    from enflow_tpu_torch.ops import edge_pipeline as ep

    shapes = dict(EDGE_WIDE_SHAPES)
    shapes["train"] = dict(shapes["train"], K=train_K)
    if generate:
        shapes["generate"] = dict(shapes["generate"], K=generate["capacity"],
                                  masked=1.0 - generate["valid"])
    rec = {}
    for H in EDGE_WIDTHS:
        for sname, base in shapes.items():
            if H not in base.get("widths", (H,)):
                continue
            shape = dict(base, H=H)
            for dname in ("bfloat16", "float32"):
                if dname not in shape.get("dtypes", (dname,)):
                    continue
                dtype = getattr(torch, dname)
                e, cd, em, W, dagg, dfs, valid = gathered_inputs(shape, dtype,
                                                                  seed=61)
                route = ep.kernel_for(dtype, H)
                padded = ep.padded_width(H) != H
                fwd = lambda: ep.edge_pipeline_fwd(e, cd, em, W)
                bwd = lambda: ep.edge_pipeline_bwd(e, cd, em, W, dagg, dfs)
                fwd_only = shape.get("fwd_only", False)
                reset_counts()
                k = fwd() if fwd_only else fwd() + bwd()
                torch.cuda.synchronize()
                n = (1, 0) if fwd_only else (1, 1)
                require(edge_routes() == route_counts(route, *n, padded)
                        and plain_calls() == 0,
                        f"edge_wide {sname} {dname} H={H}: launches "
                        f"{edge_routes()}")
                again = fwd() if fwd_only else fwd() + bwd()
                same = all(torch.equal(x, y) for x, y in zip(k, again))
                del again
                names = EDGE_OUT[:2] if fwd_only else EDGE_OUT
                p = ep.edge_pipeline_plain(e, cd, em, *W)
                if not fwd_only:
                    p = p + ep.edge_pipeline_plain_bwd(e, cd, em, *W, dagg,
                                                       dfs)
                if dname == "bfloat16":
                    errs = edge_step_errs(names, k, p, None if fwd_only else
                                          edge_wide_terms(e, cd, em, W, dagg,
                                                          dfs))
                    ok = steps_ok(errs)
                    text = steps_text(errs)
                else:
                    errs = rel_errs(names, k, p)
                    tol = {n_: (TOL_EDGE if n_ in EDGE_OUT[:4]
                                else TOL_PARAM)[dname] for n_ in names}
                    ok = all(errs[n_][1] <= tol[n_] for n_ in names)
                    text = "  ".join(f"{n_} {v[0]:.2e}/{v[1]:.1e}"
                                     for n_, v in errs.items()) + (
                        f"  tol {TOL_EDGE[dname]:g} / {TOL_PARAM[dname]:g}")
                err_f = max(errs[n_][0] for n_ in EDGE_OUT[:2])
                err_b = (None if fwd_only else
                         max(errs[n_][0] for n_ in EDGE_OUT[2:]))
                del k, p
                t_f = cuda_time_ms(fwd, reps=10, calls=5)
                d_f = device_ms(fwd, "fwd_kernel")
                t_b = d_b = None
                if not fwd_only:
                    t_b = cuda_time_ms(bwd, reps=10, calls=5)
                    d_b = device_ms(bwd, "bwd_kernel")
                Hp = ep.padded_width(H)
                fl_f, fl_b, by_f, by_b = edge_work(shape, dname,
                                                   int(valid.sum()))
                b_f = bound(fl_f, by_f, PEAK_FLOPS[dname])
                b_b = bound(fl_b, by_b, PEAK_FLOPS[dname])
                phase("edge_wide", f"{sname} {dname} A={shape['A']} "
                      f"K={shape['K']} C={shape['C']} H={H}"
                      + (f" (padded to {Hp})" if padded else "")
                      + f" ({route}) vs plain {text} -> "
                      f"{'ok' if ok else 'FAIL'}; second launch "
                      f"{'bitwise equal' if same else 'DIFFERS'}; time ms: "
                      f"K5 {t_f:.4f} (device {d_f:.4f}, bound {b_f[0]:.4f} "
                      f"{b_f[1]})" + ("" if fwd_only else
                                      f" | K6 {t_b:.4f} (device {d_b:.4f}, "
                                      f"bound {b_b[0]:.4f} {b_b[1]})"))
                require(ok, f"edge_wide {sname} {dname} H={H} disagrees with "
                        "plain")
                require(same, f"edge_wide {sname} {dname} H={H}: a second "
                        "launch gave other bits")
                rec[(sname, dname, H)] = dict(
                    err_fwd=err_f, err_bwd=err_b, ms_fwd=t_f, dev_fwd=d_f,
                    ms_bwd=t_b, dev_bwd=d_b, bound_fwd=b_f, bound_bwd=b_b)
                del e, cd, em, W, dagg, dfs
                torch.cuda.empty_cache()
    return rec


def edge_wide_phase(card, generate=None):
    """Phase edge_wide: the driver paths (``edge_wide_paths``), the checks
    (``edge_wide_checks``), the plain version timed at the kernels line's
    shapes, the padded launches' cost against H=128 at the training shape,
    and each driver run's kernel share."""
    import torch
    from enflow_tpu_torch.ops import edge_pipeline as ep

    require(EDGE_WIDE_SHAPES["topk"]["K"] == PROBE_FULL,
            "EDGE_WIDE_SHAPES' topk shape is not (b)'s capacity")
    paths = edge_wide_paths(card)
    rec = edge_wide_checks(paths["train"]["capacity"], generate)
    limits = edge_c_limits()
    phase("edge_wide", "the most edge features C a launch takes (at the "
          "padded width): " + ", ".join(f"{k} {v}" for k, v in
                                        limits.items()))
    # the one reading over its limit in the seed sweep (PERF.md section 6),
    # and the phase's own seed at that shape
    w = {}
    for seed in (EDGE_WITNESS[0], 61):
        w[seed] = edge_round_witness(seed, *EDGE_WITNESS[1:])
        require(w[seed]["same"] and w[seed]["given"] <= 1.0,
                f"edge_wide witness {EDGE_WITNESS[1:]} seed {seed}: a "
                f"repeated launch gave other bits, or the K6 sums disagree "
                f"with the plain version's on the kernel's own m and g1 "
                f"({w[seed]['given']:.2f}x)")
    # the plain version at the kernels line's shapes
    for key in (("train", "float32", EDGE_WIDE_H),
                ("topk", "bfloat16", EDGE_WIDE_H)):
        shape = dict(EDGE_WIDE_SHAPES[key[0]], H=EDGE_WIDE_H)
        if key[0] == "train":
            shape["K"] = paths["train"]["capacity"]
        e, cd, em, W, dagg, dfs, _ = gathered_inputs(
            shape, getattr(torch, key[1]), seed=61)
        r = rec[key]
        r["plain_fwd"] = cuda_time_ms(lambda: ep.edge_pipeline_plain(
            e, cd, em, *W), reps=10, calls=3)
        r["plain_bwd"] = cuda_time_ms(lambda: ep.edge_pipeline_plain_bwd(
            e, cd, em, *W, dagg, dfs), reps=10, calls=3)
        phase("edge_wide", f"{key[0]} {key[1]} H={EDGE_WIDE_H}: plain K5 "
              f"{r['plain_fwd']:.4f} ms, K6 {r['plain_bwd']:.4f} ms (kernel "
              f"events {r['ms_fwd']:.4f} / {r['ms_bwd']:.4f})")
        del e, cd, em, W, dagg, dfs
        torch.cuda.empty_cache()
    # the padded route's cost: H=96 (its weights and dagg copied into
    # buffers of 128, the outputs cut back) against H=128, f32 training
    # shape
    t = {}
    for H in (EDGE_PADDED_H, 128):
        shape = dict(EDGE_WIDE_SHAPES["train"], H=H,
                     K=paths["train"]["capacity"])
        e, cd, em, W, dagg, dfs, _ = gathered_inputs(shape, torch.float32,
                                                      seed=61)
        t[H] = (cuda_time_ms(lambda: ep.edge_pipeline_fwd(e, cd, em, W)),
                cuda_time_ms(lambda: ep.edge_pipeline_bwd(e, cd, em, W, dagg,
                                                          dfs)))
    phase("edge_wide", f"padded cost, f32 training shape: K5 H=96 (at 128) "
          f"{t[96][0]:.4f} ms vs H=128 {t[128][0]:.4f} ms "
          f"({t[96][0] / t[128][0]:.3f}x); K6 {t[96][1]:.4f} vs "
          f"{t[128][1]:.4f} ms ({t[96][1] / t[128][1]:.3f}x)")
    # kernel shares: train.yaml at 256 (5 K5 + 5 K6 a step at the
    # training shape), the top-k SMC run (its launches at its own shape)
    tr = rec[("train", "float32", EDGE_WIDE_H)]
    k_step = 5 * (tr["dev_fwd"] + tr["dev_bwd"]) / 1e3
    s_step = paths["train"]["s_step"]
    sp = rec[("topk", "bfloat16", EDGE_WIDE_H)]
    smc = paths["smc"]
    k_smc = (smc["launches"][0] * sp["dev_fwd"]
             + smc["launches"][1] * sp["dev_bwd"]) / 1e3
    phase("edge_wide", f"kernel share: train.yaml at {EDGE_WIDE_H} "
          f"{s_step:.5f} s a step, 5 x (K5 + K6) device {k_step:.5f} s "
          f"({k_step / s_step:.1%}); top-k sample_lj13 at {EDGE_WIDE_H} "
          f"{smc['secs']:.3f} s, K5 + K6 launches x device (K = 12) "
          f"{k_smc:.3f} s ({k_smc / smc['secs']:.1%})")
    return dict(rec=rec, paths=paths, padded_cost=t, witness=w)


# Phase edge_xwide: K5/K6 past H = 256 (csrc/edge_pipeline_xwide.cu,
# routes "xwide" in bf16 and "f32_xwide" in float32) and the launches at
# 64 .. 256 whose C the routes of those widths do not hold. (a) K5/K6 at
# each width of EDGE_XWIDE_HS and shape of EDGE_XWIDE_SHAPES in both dtypes
# against the plain version: outputs per element (bf16 ``edge_step_errs``,
# f32 TOL_EDGE), the bf16 parameter gradients against the float64-summed
# twin of the plain version within the parameter bound widened by FLIP_TOL
# x the root-sum-square of their terms (``edge_xwide_reading``; the plain
# version held to it too), f32 against TOL_PARAM, a second launch bitwise
# equal; the C limits of EDGE_XWIDE_C on the xwide routes; (b) K5/K6 timed
# at EDGE_XWIDE_TIMED (CUDA events, device time, the plain version, the
# bound, the library's spills); (c) train.yaml at hidden_nf EDGE_XWIDE_H
# (f32), 2 epochs and 1 resumed, then top-k vi_lj13.yaml and
# sample_lj13.yaml from its checkpoint (bf16), cut to EDGE_XWIDE_SMC
# (1024 particles x 4 of its 10 temperatures).
EDGE_XWIDE_H = 512
EDGE_XWIDE_HS = (320, 512)
EDGE_XWIDE_VI_STEPS = 3
EDGE_XWIDE_SMC = dict(n_particles=1024, n_temps=4)
EDGE_XWIDE_SHAPES = {
    "train": dict(A=390, K=24, C=3, masked=0.2),
    "topk": dict(A=2048 * 13, K=12, C=11, masked=0.0),
    "generate": dict(A=2944, K=56, C=3, masked=0.5, fwd_only=True),
    "k80": dict(A=96, K=80, C=3, masked=0.3),
    "ragged": dict(A=203, K=13, C=7, masked=0.5, dead=17),
}
# (dtype, H, C, a direction whose route of H does not hold C): the first C
# past each old limit (bf16 C <= 64, and <= 48 in the K6 at 256; f32 K6 C
# <= 78 and K5 C <= 155 at 128), C = 2 nf + 1 as the edge rows have it
EDGE_XWIDE_C = (("bfloat16", 128, 65, "fwd"), ("bfloat16", 256, 49, "bwd"),
                ("float32", 128, 79, "bwd"), ("float32", 128, 159, "fwd"))
EDGE_XWIDE_TIMED = (("train", "float32"), ("train", "bfloat16"),
                    ("topk", "bfloat16"), ("generate", "float32"))


def edge_f64_twin(e, cd, em, W, dagg, dfs, mag=False):
    """{gradient: f32} of ``edge_plain_sums`` with every product and sum in
    float64, its rounding points kept (``mag``: the sums of the terms'
    magnitudes, ``"l2"`` their root-sum-square), summed over batches of
    atoms that keep each [rows, H] tensor under 2^26 elements."""
    import torch
    A, K = em.shape
    chunk = max(1, 2 ** 26 // (K * W[2].shape[1]))
    tot = None
    for a0 in range(0, A, chunk):
        s = slice(a0, a0 + chunk)
        g = edge_plain_sums(e[s], cd[s], em[s], W, dagg[s], dfs[s], mag=mag,
                            acc=torch.float64)
        tot = g if tot is None else {k: tot[k] + g[k] for k in g}
    if mag == "l2":
        tot = {k: v.sqrt() for k, v in tot.items()}
    return {k: v.float() for k, v in tot.items()}


def edge_gate_widen(e, cd, em, W, dfs):
    """{"F_sum": [A, 3], "dcd": [A, K, 3]}: how far a flip of the rounded
    g1 terms of each slot's gate may carry F_sum and dcd: FLIP_TOL x the
    root-sum-square of the gate's terms g1_c w4_c (the plain version's g1)
    times |cd| of the unclipped valid slots summed over K, and times
    |dtr|. The gate is an f32 sum of H rounded bf16 terms, as a parameter
    gradient is of its edges' (FLIP_TOL)."""
    import torch
    from enflow_tpu_torch.ops import edge_pipeline as ep
    emf, *_, g1, gate = ep._recompute(e, em, *W)
    rss = (g1.float() * W[6].float()[:, 0]).square().sum(-1).sqrt()[..., None]
    del g1
    cdf = cd.float()
    pre = cdf * gate
    inside = ((pre > -100.0) & (pre < 100.0)).float() * emf
    return {"F_sum": FLIP_TOL * (cdf.abs() * inside * rss).sum(1),
            "dcd": FLIP_TOL * rss * (dfs.float()[:, None, :]
                                     * inside).abs()}


def edge_f64_outputs(e, cd, em, W, dagg, dfs, fwd_only=False):
    """(agg, F_sum[, de, dcd]) of the plain version with every product and
    sum in float64, its rounding points kept (in the compute dtype), over
    batches of atoms that keep each [rows, H] tensor under 2^26
    elements."""
    import torch
    from enflow_tpu_torch.ops import edge_pipeline as ep
    A, K = em.shape
    chunk = max(1, 2 ** 26 // (K * W[2].shape[1]))
    acc = ep._acc
    ep._acc = lambda dt: torch.float64
    try:
        parts = []
        for a0 in range(0, A, chunk):
            s = slice(a0, a0 + chunk)
            out = ep.edge_pipeline_plain(e[s], cd[s], em[s], *W)
            if not fwd_only:
                out = out + ep.edge_pipeline_plain_bwd(
                    e[s], cd[s], em[s], *W, dagg[s], dfs[s])[:2]
            parts.append(out)
    finally:
        ep._acc = acc
    return tuple(torch.cat(x) for x in zip(*parts))


def edge_xwide_reading(names, got, want, args, dname):
    """(ok, text, max abs err) of K5/K6 outputs ``names`` against the plain
    version: bf16 outputs per element (``edge_step_errs``; F_sum and dcd
    widened by ``edge_gate_widen``, and the plain version held to the same
    limits against ``edge_f64_outputs``) and the seven parameter
    gradients, the kernel's and the plain version's, against
    ``edge_f64_twin`` within the bound widened by FLIP_TOL x their terms'
    root-sum-square (``step_errs``' ``flips``); f32 against TOL_EDGE /
    TOL_PARAM."""
    outs = [n for n in names if n in EDGE_OUT[:4]]
    params = [n for n in names if n in EDGE_OUT[4:]]
    k = dict(zip(names, got))
    p = dict(zip(names, want))
    if dname == "float32":
        errs = rel_errs(names, got, want)
        ok = all(errs[n][1] <= (TOL_EDGE if n in outs else TOL_PARAM)[dname]
                 for n in names)
        text = "  ".join(f"{n} {a:.2e}/{r:.1e}" for n, (a, r) in errs.items())
        return ok, text, max(a for a, _ in errs.values())
    e, cd, em, W, dagg, dfs = args
    widen = edge_gate_widen(e, cd, em, W, dfs)
    twin = dict(zip(outs, edge_f64_outputs(*args, fwd_only=not params)))
    errs = edge_step_errs(outs, [k[n] for n in outs], [p[n] for n in outs],
                          widen=widen)
    errs_p = edge_step_errs(outs, [p[n] for n in outs],
                            [twin[n] for n in outs], widen=widen)
    del widen, twin
    ok = steps_ok(errs) and steps_ok(errs_p)
    text = steps_text(errs) + " (plain vs the f64-summed twin " + "  ".join(
        f"{n} {errs_p[n][1]:.2f}" for n in outs) + ")"
    err = max(a for a, _, _ in errs.values())
    if params:
        twin = edge_f64_twin(*args)
        terms = edge_f64_twin(*args, mag=True)
        flips = edge_f64_twin(*args, mag="l2")
        read = lambda src: step_errs(params, [src[n] for n in params],
                                     [twin[n] for n in params], terms,
                                     flips=flips)
        rk, rp = read(k), read(p)
        ok = ok and steps_ok(rk) and steps_ok(rp)
        err = max(err, max(a for a, _, _ in rk.values()))
        text += "; vs the f64-summed twin " + "  ".join(
            f"{n} {rk[n][1]:.2f}x (plain {rp[n][1]:.2f}x)" for n in params)
    return ok, text, err


def edge_xwide_launch(label, shape, dname, seed, route=None):
    """K5 (and K6 unless ``fwd_only``) at ``shape`` through the entry
    points against the plain version (``edge_xwide_reading``), each launch
    on the route ``kernel_for`` names for its direction and C (``route``:
    the xwide route of the dtype that it must name in at least one
    direction), a second launch bitwise equal. Returns (fwd, bwd, the
    reading's text, max abs err, the valid slots, the routes)."""
    import torch
    from enflow_tpu_torch.ops import edge_pipeline as ep
    dt = getattr(torch, dname)
    e, cd, em, W, dagg, dfs, valid = gathered_inputs(shape, dt, seed)
    args = (e, cd, em, W, dagg, dfs)
    H, C = shape["H"], shape["C"]
    fwd_only = shape.get("fwd_only", False)
    fwd = lambda: ep.edge_pipeline_fwd(e, cd, em, W)
    bwd = lambda: ep.edge_pipeline_bwd(e, cd, em, W, dagg, dfs)
    routes = {d: ep.kernel_for(dt, H, C, d) for d in ("fwd", "bwd")}
    reset_counts()
    got = fwd() if fwd_only else fwd() + bwd()
    torch.cuda.synchronize()
    want_c = route_counts(routes["fwd"], 1, 0,
                          ep.padded_width(H) != H)
    if not fwd_only:
        want_c[routes["bwd"]] = (want_c[routes["bwd"]][0], 1)
        if ep.padded_width(H) != H:
            want_c["padded"] = (1, 1)
    require(edge_routes() == want_c and plain_calls() == 0,
            f"edge_xwide {label} {dname} H={H}: launches {edge_routes()} "
            f"!= {want_c}")
    require(route is None or route in routes.values(),
            f"edge_xwide {label} {dname} H={H} C={C}: routes {routes}, "
            f"not {route}")
    again = fwd() if fwd_only else fwd() + bwd()
    same = all(torch.equal(x, y) for x, y in zip(got, again))
    del again
    names = EDGE_OUT[:2] if fwd_only else EDGE_OUT
    want = ep.edge_pipeline_plain(e, cd, em, *W)
    if not fwd_only:
        want = want + ep.edge_pipeline_plain_bwd(e, cd, em, *W, dagg, dfs)
    ok, text, err = edge_xwide_reading(names, got, want, args, dname)
    del got, want
    require(ok, f"edge_xwide {label} {dname} H={H} C={C} disagrees with "
            f"plain: {text}")
    require(same, f"edge_xwide {label} {dname} H={H} C={C}: a second launch "
            "gave other bits")
    return fwd, (None if fwd_only else bwd), text, err, int(valid.sum()), \
        routes


def edge_xwide_checks(card):
    """(a): the library's shared memory and threads beside the mirror
    (tests/egcl_smem_mirror.py), every width of EDGE_XWIDE_HS x shape of
    EDGE_XWIDE_SHAPES in both dtypes, A = 0, and the C limits of
    EDGE_XWIDE_C; returns {(shape, dtype, H): (max abs err, valid)}."""
    import torch
    from enflow_tpu_torch.ops import edge_pipeline as ep
    sys.path.insert(0, str(ROOT / "tests"))
    import egcl_smem_mirror as mirror
    lib = ep._xwide_library()
    for code in (1, 0):
        got = {(C, H, d): lib.edge_xwide_smem_bytes(code, C, H, d)
               for C in (3, 11, 129) for H in (64, 320, 512, ep.XWIDE_MAX_H)
               for d in (0, 1)}
        want = {k: mirror.edge_xwide_bytes(code, *k) for k in got}
        require(got == want and len(set(got.values())) == 1
                and lib.edge_xwide_max_width() == ep.XWIDE_MAX_H,
                f"edge_xwide shared memory (code {code}): library {got}, "
                f"mirror {want}")
        phase("edge_xwide", f"(a) {'bf16' if code else 'float32'}: "
              f"{lib.edge_xwide_threads(code)} threads and "
              f"{next(iter(got.values())):,} bytes of shared memory a block "
              f"at every C of 3, 11, 129 and H of 64, 320, 512, "
              f"{ep.XWIDE_MAX_H} in both directions (the mirror's too), of "
              f"{lib.edge_xwide_smem_limit():,}")
    rec = {}
    for H in EDGE_XWIDE_HS:
        for sname, base in EDGE_XWIDE_SHAPES.items():
            for dname in ("bfloat16", "float32"):
                shape = dict(base, H=H)
                route = ep.XWIDE_ROUTE[getattr(torch, dname)]
                _, _, text, err, valid, _ = edge_xwide_launch(
                    sname, shape, dname, 61, route)
                rec[(sname, dname, H)] = (err, valid)
                phase("edge_xwide", f"(a) {sname} {dname} A={shape['A']} "
                      f"K={shape['K']} C={shape['C']} H={H} ({route}) vs "
                      f"plain: {text} -> ok; a second launch bitwise equal")
                torch.cuda.empty_cache()
    # no atoms: zeros, and no launch
    for dname in ("bfloat16", "float32"):
        dt = getattr(torch, dname)
        _, _, _, W, _, _, _ = gathered_inputs(
            dict(A=4, K=12, C=11, H=EDGE_XWIDE_H, masked=0.0), dt, 61)
        z = lambda *s: torch.zeros(s, dtype=dt, device="cuda")
        e, cd, em = z(0, 12, 11), z(0, 12, 3), z(0, 12)
        reset_counts()
        out = (ep.edge_pipeline_fwd(e, cd, em, W)
               + ep.edge_pipeline_bwd(e, cd, em, W, z(0, EDGE_XWIDE_H),
                                      z(0, 3)))
        shapes = [tuple(t.shape) for t in out]
        require(shapes == [(0, EDGE_XWIDE_H), (0, 3), (0, 12, 11), (0, 12, 3)]
                + [tuple(w.shape) for w in W]
                and not any(bool(g.any()) for g in out[4:])
                and ep.kernel_for(dt, EDGE_XWIDE_H, 11) == ep.XWIDE_ROUTE[dt]
                and edge_routes() == route_counts(ep.XWIDE_ROUTE[dt], 0, 0),
                f"edge_xwide A=0 {dname}: {shapes}, {edge_routes()}")
        phase("edge_xwide", f"(a) A=0 {dname} H={EDGE_XWIDE_H} (route "
              f"{ep.XWIDE_ROUTE[dt]}): empty outputs and seven zero "
              "parameter gradients, no launch")
    # the C limits of the routes at 64 .. 256 (ROADMAP B7.3, closed)
    for dname, H, C, direction in EDGE_XWIDE_C:
        shape = dict(A=300, K=12, C=C, H=H, masked=0.2)
        route = ep.XWIDE_ROUTE[getattr(torch, dname)]
        _, _, text, _, _, routes = edge_xwide_launch(
            f"C={C}", shape, dname, 67, route)
        require(routes[direction] == route, f"C={C} H={H} {dname} "
                f"{direction}: route {routes[direction]}")
        phase("edge_xwide", f"(a) C={C} {dname} H={H} A=300 K=12: K5 on "
              f"{routes['fwd']}, K6 on {routes['bwd']} vs plain: {text} -> "
              f"ok; a second launch bitwise equal")
    return rec


def edge_xwide_kernels(card):
    """(b): K5/K6 at EDGE_XWIDE_TIMED (H = EDGE_XWIDE_H): CUDA events,
    device time, the plain version, the bound (``edge_work``); returns
    {(shape, dtype): record}."""
    import torch
    from enflow_tpu_torch.ops import edge_pipeline as ep
    rec = {}
    for sname, dname in EDGE_XWIDE_TIMED:
        shape = dict(EDGE_XWIDE_SHAPES[sname], H=EDGE_XWIDE_H)
        fwd, bwd, text, err, valid, _ = edge_xwide_launch(
            sname, shape, dname, 73)
        dt = getattr(torch, dname)
        e, cd, em, W, dagg, dfs, _ = gathered_inputs(shape, dt, 73)
        fl_f, fl_b, by_f, by_b = edge_work(shape, dname, valid)
        r = dict(err=err)
        for d, fn, fl, by in (("fwd", fwd, fl_f, by_f),
                              ("bwd", bwd, fl_b, by_b)):
            if fn is None:
                continue
            plain = ((lambda: ep.edge_pipeline_plain(e, cd, em, *W))
                     if d == "fwd" else
                     (lambda: ep.edge_pipeline_plain_bwd(e, cd, em, *W,
                                                         dagg, dfs)))
            r[f"plain_{d}"] = cuda_time_ms(plain, reps=3, calls=1, warmup=1)
            torch.cuda.empty_cache()
            r[f"ms_{d}"] = cuda_time_ms(fn, reps=5, calls=2, warmup=1)
            r[f"dev_{d}"] = device_ms(fn, "edge_xwide_kernel", calls=6,
                                      warmup=1)
            r[f"bound_{d}"] = bound(fl, by, PEAK_FLOPS[dname])
            phase("edge_xwide", f"(b) {sname} {dname} A={shape['A']} "
                  f"K={shape['K']} C={shape['C']} H={EDGE_XWIDE_H} "
                  f"{'K5' if d == 'fwd' else 'K6'} on {card}: events "
                  f"{r[f'ms_{d}']:.4f} ms, device {r[f'dev_{d}']:.4f} ms, "
                  f"plain {r[f'plain_{d}']:.4f} ms, bound "
                  f"{r[f'bound_{d}'][0]:.4f} ms ({r[f'bound_{d}'][1]}, "
                  f"{fl / 1e9:.2f} GFLOP, {by / 1e6:.2f} MB), "
                  f"{fl / (r[f'dev_{d}'] * 1e9):.2f} TFLOP/s; vs plain "
                  f"{text}")
        rec[(sname, dname)] = r
        del e, cd, em, W, dagg, dfs, fwd, bwd
        torch.cuda.empty_cache()
    if "edge_pipeline_xwide" in BUILD_SPILLS:
        spills = BUILD_SPILLS["edge_pipeline_xwide"]
        phase("edge_xwide", f"(b) ptxas: {len(spills)} functions of "
              "edge_pipeline_xwide.cu spill" + "".join(f"\n  {f}"
                                                       for f in spills))
    return rec


def edge_xwide_paths(card):
    """(c): train.yaml at hidden_nf EDGE_XWIDE_H (float32, f32_xwide), 2
    epochs then 1 resumed; top-k vi_lj13.yaml at EDGE_XWIDE_H 1 x
    EDGE_XWIDE_VI_STEPS steps and top-k sample_lj13.yaml from its
    checkpoint cut to EDGE_XWIDE_SMC (bf16, xwide). Launches held exactly,
    no plain call."""
    import os
    cwd = os.getcwd()
    try:
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            a = edge_wide_train(card, EDGE_XWIDE_H, 2, True, tmp,
                                "model_x.cpt")
            a["s_step"] = statistics.median(
                a["step_s"][TRAIN_STEPS_PER_EPOCH:])
            phase("edge_xwide", f"(c) train.yaml at hidden_nf "
                  f"{EDGE_XWIDE_H} on {card}: auto capacity "
                  f"{a['capacity']}, 2 epochs x {TRAIN_STEPS_PER_EPOCH} "
                  f"steps, {a['s_step']:.5f} s/step (median of epoch 2; "
                  f"first step {a['step_s'][0]:.4f} s), losses "
                  + ", ".join(f"{x:.2f}" for x in a["losses"])
                  + f"; K5/K6 {a['launches']} on f32_xwide (5 + 5 a step), "
                  f"0 on any other route, plain 0; resumed epoch 3: K5/K6 "
                  f"{a['resumed']}, losses " + ", ".join(
                      f"{x:.2f}" for x in a["resumed_losses"])
                  + f" ({time.perf_counter() - t0:.1f} s with the dataset)")
    finally:
        os.chdir(cwd)
    out = dict(train=a)
    out.update(topk_vi_sample(card, "edge_xwide", EDGE_XWIDE_H, "xwide",
                              EDGE_XWIDE_VI_STEPS, EDGE_XWIDE_SMC))
    return out


def edge_xwide_phase(card):
    """Phase edge_xwide: (a) ``edge_xwide_checks``, (b)
    ``edge_xwide_kernels``, (c) ``edge_xwide_paths``, and each driver
    run's kernel share."""
    checks = edge_xwide_checks(card)
    rec = edge_xwide_kernels(card)
    paths = edge_xwide_paths(card)
    tr, sp = rec[("train", "float32")], rec[("topk", "bfloat16")]
    k_step = 5 * (tr["dev_fwd"] + tr["dev_bwd"]) / 1e3
    s_step = paths["train"]["s_step"]
    smc = paths["smc"]
    # the run's batch is smc["P"] molecules, the timed shape's 2048: its
    # device times scaled by the rows
    scale = smc["P"] * 13 / EDGE_XWIDE_SHAPES["topk"]["A"]
    k_smc = scale * (smc["launches"][0] * sp["dev_fwd"]
                     + smc["launches"][1] * sp["dev_bwd"]) / 1e3
    phase("edge_xwide", f"kernel share: train.yaml at {EDGE_XWIDE_H} "
          f"{s_step:.5f} s a step, 5 x (K5 + K6) device {k_step:.5f} s "
          f"({k_step / s_step:.1%}); top-k sample_lj13 at {EDGE_XWIDE_H} "
          f"({smc['P']} particles, {smc['T']} temps) {smc['secs']:.3f} s, "
          f"K5 + K6 launches x device time at 2048 molecules scaled by "
          f"{scale:.3f} to its rows {k_smc:.3f} s ({k_smc / smc['secs']:.1%})")
    return dict(checks=checks, rec=rec, paths=paths)


def edge_seed_sweep(first, last):
    """The bf16 Hopper K5/K6 against their plain version at every bf16
    shape of EDGE_SHAPES for the input seeds first..last: each reading
    (the largest relative error of agg, F_sum, de, dcd and of the
    parameter gradients' f32 sums) beside TOL_EDGE and TOL_PARAM, and how
    many exceed them; then phase edge_wide's bf16 readings (below). A
    measurement of how the tensor cores' sums move bf16 roundings, not a
    check: it fails only on a kernel that does not run or whose second
    launch gives other bits."""
    import torch
    from enflow_tpu_torch.ops import edge_pipeline as ep

    over = {}
    names = [n for n, sh in EDGE_SHAPES.items()
             if "bfloat16" in sh.get("dtypes", ("bfloat16",))
             and ep.kernel_for(torch.bfloat16, sh["H"]) == "sm90"]
    for seed in range(first, last + 1):
        for sname in names:
            e, cd, em, W, dagg, dfs, _ = gathered_inputs(
                EDGE_SHAPES[sname], torch.bfloat16, seed)
            k = (ep.edge_pipeline_fwd(e, cd, em, W)
                 + ep.edge_pipeline_bwd(e, cd, em, W, dagg, dfs))
            p = (ep.edge_pipeline_plain(e, cd, em, *W)
                 + ep.edge_pipeline_plain_bwd(e, cd, em, *W, dagg, dfs))
            errs = rel_errs(EDGE_OUT, k, p)
            out = max(EDGE_OUT[:4], key=lambda n: errs[n][1])
            par = max(EDGE_OUT[4:], key=lambda n: errs[n][1])
            bad = (errs[out][1] > TOL_EDGE["bfloat16"]
                   or errs[par][1] > TOL_PARAM["bfloat16"])
            if bad:
                over[(sname, seed)] = (out, errs[out][1], par, errs[par][1])
            phase("edge-seeds", f"{sname} seed {seed}: outputs "
                  f"{errs[out][1]:.2e} ({out}), parameter gradients "
                  f"{errs[par][1]:.2e} ({par})" + (" over" if bad else ""))
    n = (last - first + 1) * len(names)
    phase("edge-seeds", f"{len(over)} of {n} readings over TOL_EDGE "
          f"{TOL_EDGE['bfloat16']:g} / TOL_PARAM {TOL_PARAM['bfloat16']:g}"
          + "".join(f"; {k[0]} seed {k[1]}: {v[0]} {v[1]:.2e}, {v[2]} "
                    f"{v[3]:.2e}" for k, v in over.items()))
    # phase edge_wide's bf16 readings (EDGE_WIDTHS and H=128 at
    # EDGE_WIDE_SHAPES): per element as edge_step_errs reads them, and F_sum
    # and dcd also at STEP_FLOOR; a second launch bitwise equal; each case
    # over its limits then read by edge_round_witness
    worst, over = {}, []
    launch = lambda a: (ep.edge_pipeline_fwd(*a[:3], a[3])
                        + ep.edge_pipeline_bwd(*a[:3], a[3], *a[4:]))
    for H in EDGE_WIDTHS + (128,):
        for sname, base in EDGE_WIDE_SHAPES.items():
            if ("bfloat16" not in base.get("dtypes", ("bfloat16",))
                    or H not in base.get("widths", (H,))):
                continue
            for seed in range(first, last + 1):
                args = gathered_inputs(dict(base, H=H), torch.bfloat16,
                                       seed)[:6]
                k = launch(args)
                require(all(torch.equal(x, y) for x, y in zip(
                    k, launch(args))), f"H={H} {sname} seed {seed}: a "
                    "second launch gave other bits")
                p = (ep.edge_pipeline_plain(*args[:3], *args[3])
                     + ep.edge_pipeline_plain_bwd(*args[:3], *args[3],
                                                  *args[4:]))
                errs = edge_step_errs(EDGE_OUT, k, p, edge_wide_terms(*args))
                floor = step_errs(("F_sum", "dcd"), k[1::2][:2],
                                  p[1::2][:2])
                read = {n: r for n, (_, r, _) in errs.items()}
                read.update({f"{n} at STEP_FLOOR": r
                             for n, (_, r, _) in floor.items()})
                for n, r in read.items():
                    worst[n] = max(worst.get(n, (0.0, "")),
                                   (r, f"H={H} {sname} seed {seed}"))
                if not steps_ok(errs):
                    over.append((seed, H, sname))
                phase("edge-seeds", f"H={H} {sname} seed {seed}: "
                      + steps_text(errs))
                del args, k, p
                torch.cuda.empty_cache()
    phase("edge-seeds", "edge_wide readings, largest: " + ", ".join(
        f"{n} {r:.2f} ({at})" for n, (r, at) in worst.items())
        + f"; over their limits: {len(over)} (" + ", ".join(
            f"H={H} {sname} seed {seed}" for seed, H, sname in over) + ")")
    for seed, H, sname in over:
        shape = EDGE_WIDE_SHAPES[sname]
        if shape["A"] * shape["K"] <= WITNESS_EDGES:
            edge_round_witness(seed, H, sname)
        else:
            phase("edge-witness", f"H={H} {sname} seed {seed}: more than "
                  f"{WITNESS_EDGES} edges, not read out")


# the all-pairs seed sweep: the bf16 kernels at VI's batch of LJ13-size
# molecules and at phase kernel's width-check shapes (B=16, two padded
# atoms), at each width of the Hopper kernels (one-molecule or block pairs
# at 64 / 128, streamed block pairs at 192 / 256) and padded onto them (96,
# 160); the outputs' steps also read at these floors
SWEEP_H = (64, 96, 128, 160, 192, 256)
SWEEP_SHAPES = (dict(B=256, N=13, nf=5, n_pad=2),
                dict(B=16, N=55, nf=5, n_pad=2),
                dict(B=16, N=147, nf=5, n_pad=2))
SWEEP_FLOORS = (2.0 ** -2, 2.0 ** -4, 2.0 ** -6, 2.0 ** -8)


def bf16_ulp(x):
    """The spacing of bf16 values at ``x`` (a tensor; 0 where x is 0)."""
    import torch
    e = torch.floor(torch.log2(x.abs().clamp_min(1e-30)))
    return torch.where(x == 0, torch.zeros_like(x), torch.exp2(e - 7))


def allpairs_seed_sweep(first, last):
    """bf16 K1, K2 and K2 p against their plain version at each shape of
    SWEEP_SHAPES and H of SWEEP_H for the input seeds first..last: per
    seed and per (shape, H) over the seeds, the largest ``step_errs``
    readings (the outputs' bf16 steps at each floor of SWEEP_FLOORS, the
    parameter gradients' share of their bound and their largest |kernel -
    plain| over the terms' magnitudes), the seeds a reading exceeds its
    limit at, and the seeds TOL / TOL_PARAM's max-relative reading
    (``rel_errs``) exceeds at. A measurement of the limits, not a check:
    it fails only on a kernel that does not run."""
    import torch
    from enflow_tpu_torch.ops import egcl_allpairs as ops

    outs = ("agg", "f_sum", "dh", "dpos", "dh p", "dpos p")
    tol = {n: (TOL_PARAM if n in PARAM_OUT[2:] else TOL)["bfloat16"]
           for n in outs + PARAM_OUT[2:]}
    for shape in SWEEP_SHAPES:
        for H in SWEEP_H:
            worst = dict(steps={f: 0.0 for f in SWEEP_FLOORS}, share=0.0,
                         terms=0.0)
            over, over_tol = [], []
            for seed in range(first, last + 1):
                args = edge_inputs(dict(shape, H=H), torch.bfloat16,
                                   seed)[:7]
                k = (ops.allpairs_edges_fwd(*args[:5])
                     + ops.allpairs_edges_bwd(*args)
                     + ops.allpairs_edges_bwd(*args, params=True))
                p = (ops.allpairs_edges_plain(*args[:5])
                     + ops.allpairs_edges_plain_bwd(*args)
                     + ops.allpairs_edges_plain_bwd(*args, params=True))
                terms = plain_terms(args)
                names = outs + PARAM_OUT[2:]
                steps = {f: max(r for _, r, _ in step_errs(
                    outs, k[:6], p[:6], floor=f).values())
                    for f in SWEEP_FLOORS}
                errs = step_errs(names, k, p, terms)
                share = max(errs[n][1] for n in PARAM_OUT[2:])
                ratio = max(float(((k[i].float() - p[i].float()).abs()
                                   / terms[n].clamp_min(1e-30)).max())
                            for i, n in enumerate(names) if n in terms)
                rel = rel_errs(names, k, p)
                if not steps_ok(errs):
                    over.append(seed)
                if any(r > tol[n] for n, (_, r) in rel.items()):
                    over_tol.append(seed)
                for f in SWEEP_FLOORS:
                    worst["steps"][f] = max(worst["steps"][f], steps[f])
                worst["share"] = max(worst["share"], share)
                worst["terms"] = max(worst["terms"], ratio)
                phase("allpairs-seeds", f"B={shape['B']} N={shape['N']} "
                      f"H={H} seed {seed}: outputs' bf16 steps at floors "
                      + ", ".join(f"2^{math.log2(f):.0f} {v:.2f}"
                                  for f, v in steps.items())
                      + f"; parameter gradients {share:.3f}x their bound, "
                      f"|diff| / terms {ratio:.2e}; max-relative "
                      + "  ".join(f"{n} {r:.1e}" for n, (_, r) in rel.items()
                                  if r > tol[n]))
                del k, p, terms
            phase("allpairs-seeds", f"B={shape['B']} N={shape['N']} H={H}, "
                  f"seeds {first}-{last}: largest outputs' steps "
                  + ", ".join(f"2^{math.log2(f):.0f} {v:.2f}"
                              for f, v in worst["steps"].items())
                  + f"; parameter gradients {worst['share']:.3f}x their "
                  f"bound, |diff| / terms {worst['terms']:.2e}; over the "
                  f"per-element limits at seeds {over}, over TOL / "
                  f"TOL_PARAM at {over_tol}")
            torch.cuda.empty_cache()


def pair_inputs(shape, seed):
    """Positions, mask and box on the card for the K7 contract. Form r at
    N=13 puts 8 atoms on a 2x2x2 lattice of spacing box/2, so that their
    displacements sit exactly on the half-box rounding boundary (round
    half to even), and the rest near the cell centres; form r2 has a
    coincident pair (excluded, d2 = 0) and padded atoms; the large box is
    a jittered cubic lattice; "r_tie" two atoms one ulp past half a box
    apart; "r_generate" generate.yaml's grid start (the port's
    ``arrange_points_on_grid`` with the dataset's 1 A gap) jittered by a
    seeded numpy draw."""
    import numpy as np
    import torch
    gen = torch.Generator().manual_seed(seed)
    B, N = shape["B"], shape["N"]
    mask = torch.ones((B, N), dtype=torch.bool)
    box = torch.full((B, 3), shape.get("box", 1.0))
    if shape["form"] == "r2":
        pos = torch.randn((B, N, 3), generator=gen) * 1.2
        pos[0, 1] = pos[0, 0]
        mask[1, N - 2:] = False
    elif shape.get("tie"):
        bx = np.float32(shape["box"])
        pos = torch.zeros((B, N, 3))
        pos[:, 1, 0] = float(np.nextafter(np.float32(0.5) * bx,
                                          np.float32(np.inf)))
    elif shape.get("generate"):
        from enflow_tpu_torch.data.lj import arrange_points_on_grid
        from enflow_tpu_torch.utils import conversion as cv
        side = cv.dist_to_lj(shape["box_ang"], "ang")
        grid = arrange_points_on_grid(N, [side] * 3, cv.dist_to_lj(1.0,
                                                                   "ang"))
        rng = np.random.default_rng(seed)
        pos = torch.from_numpy(grid + 0.05 * rng.normal(size=grid.shape))[
            None].float().expand(B, N, 3)
        box = torch.full((B, 3), side)
    elif N == 13:
        half = shape["box"] / 2
        grid = torch.tensor([[a, b, c] for a in (0, 1) for b in (0, 1)
                             for c in (0, 1)], dtype=torch.float32) * half
        faces = torch.tensor([[.5, .5, 0], [.5, .5, 1], [.5, 0, .5],
                              [.5, 1, .5], [0, .5, .5]]) * half
        rest = faces + 0.02 * torch.randn((B, N - 8, 3), generator=gen)
        pos = torch.cat([grid.expand(B, 8, 3), rest], dim=1)
        if shape.get("coincident"):
            pos[:, 1] = pos[:, 0]
    else:
        n_side = math.ceil(N ** (1 / 3))
        g = torch.arange(n_side, dtype=torch.float32)
        sites = torch.stack(torch.meshgrid(g, g, g, indexing="ij"),
                            -1).reshape(-1, 3)[:N]
        spacing = shape["box"] / n_side
        pos = (sites * spacing + 0.05 * torch.randn((B, N, 3), generator=gen)
               - shape["box"] / 2)
        mask[:, N - shape["n_pad"]:] = False
    pos = pos * mask[..., None]
    c = lambda t: t.to(device="cuda", dtype=torch.float32).contiguous()
    return c(pos), c(mask), c(box)


def pair_work(form, pos, mask, box, cutoff, coincident=False):
    """(FLOP, bytes) of K7 on these inputs. Every ordered pair of distinct
    real atoms needs its distance test: 8 operations in form r2
    (displacement 3, d2 5) and 20 in form r (the min-image 12 more: a
    division, rint, product and difference an axis), and each valid pair
    (both real, d2 > 0 or, with the flag, distinct and coincident, inside
    the cutoff) 22 (r2) or 27 (r) more: the pair terms 12 / 17 and the
    sums 10 (a division, square root or rint counts as one). Bytes:
    positions, mask and box read once, the gradient and the energies
    written once."""
    import torch
    d = pos[:, :, None, :] - pos[:, None, :, :]
    if form == "r":
        d = d - torch.round(d / box[:, None, None, :]) * box[:, None, None, :]
    d2 = (d * d).sum(-1)
    real = mask[:, :, None] * mask[:, None, :] > 0
    other = ~torch.eye(d2.shape[1], dtype=torch.bool, device=d2.device)
    valid = real & (d2 > 0)
    if coincident:
        valid = valid | (real & other & (d2 == 0))
    if form == "r":
        valid = valid & (d2 < cutoff * cutoff)
    tested, pairs = float((real & other).sum()), float(valid.sum())
    B, N = mask.shape
    flop = (tested * (8 if form == "r2" else 20)
            + pairs * (22 if form == "r2" else 27))
    return flop, 4 * (B * N * 7 + B * 4)


def pair_device_ms(fn, plan):
    """Device time of one K7 call: (the pair kernel, the partials' sum
    where the plan has one, else 0)."""
    return (device_ms(fn, "pair_energy_kernel"),
            device_ms(fn, "pair_reduce_kernel") if plan.units > 1 else 0.0)


def pair_kernel_phase():
    """K7 against its plain version at PAIR_SHAPES (float32): a second
    launch bitwise equal, CUDA events and device time, the bound."""
    import torch
    from enflow_tpu_torch.ops import build
    from enflow_tpu_torch.ops import pair_energy as pe

    record = {}
    for sname, shape in PAIR_SHAPES.items():
        pos, mask, box = pair_inputs(shape, seed=17)
        form, soft = shape["form"], shape["softening"]
        cut, coinc = shape.get("cutoff"), shape.get("coincident", False)
        call = lambda: pe.pair_energy_and_grad(pos, mask, box, form, soft,
                                               cut, coinc)
        k = call()
        again = call()
        p = pe.pair_energy_plain(pos, mask, box, form, soft, cut, coinc)
        torch.cuda.synchronize()
        errs = rel_errs(("E", "dE/dpos"), k, p)
        same = all(bool(torch.equal(a, b)) for a, b in zip(k, again))
        ok = same and all(rel <= TOL_PAIR for _, rel in errs.values())
        note = ""
        if coinc and soft > 0:
            # the flag adds the coincident pair's 4(s^-12 - s^-6) and no
            # force; without it the kernel leaves the pair out
            off = pe.pair_energy_and_grad(pos, mask, box, form, soft, cut)
            added = float(k[0][0] - off[0][0])
            want = 4.0 * (soft ** -12 - soft ** -6)
            same_f = bool(torch.equal(k[1], off[1]))
            ok = ok and abs(added / want - 1.0) < TOL_PAIR and same_f
            note = (f"; the flag adds {added:.6e} (4(s^-12 - s^-6) = "
                    f"{want:.6e}), forces unchanged: {same_f}")
        plan = pe.pair_plan(shape["B"], shape["N"],
                            build.multiprocessors(pos.device))
        phase("pair", f"{sname} B={shape['B']} N={shape['N']} ({plan}) "
              "max_abs/rel err: " + "  ".join(
                  f"{n} {a:.2e}/{r:.1e}" for n, (a, r) in errs.items())
              + f"  tol {TOL_PAIR:g}; a second launch gives the same bits: "
              f"{same}{note} -> {'ok' if ok else 'FAIL'}")
        require(ok, f"pair kernel disagrees with plain ({sname})")
        t_k = cuda_time_ms(call)
        t_main, t_red = pair_device_ms(call, plan)
        t_d = t_main + t_red
        t_p = cuda_time_ms(lambda: pe.pair_energy_plain(
            pos, mask, box, form, soft, cut, coinc), reps=20, calls=5)
        flop, nbytes = pair_work(form, pos, mask, box, cut, coinc)
        b = bound(flop, nbytes, PEAK_FLOPS["float32"])
        phase("pair", f"{sname} time ms: kernel {t_k:.4f} (device "
              f"{t_d:.4f}" + (f" = pairs {t_main:.4f} + partials' sum "
                              f"{t_red:.4f}" if t_red else "")
              + f"; host {host_ms(call):.4f} a call) plain {t_p:.4f} bound "
              f"{b[0]:.6f} ({b[1]}, {flop / 1e6:.3f} MFLOP)")
        record[sname] = dict(err=max(a for a, _ in errs.values()), ms=t_k,
                             device=t_d, plain=t_p, bound=b)
        torch.cuda.empty_cache()
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


def flags_phase():
    """A flagged EGCL (attention, norm_diff and tanh on, use_pallas off)
    on the card in all_pairs and images mode, through the flow's
    ``_egcl_at``: it must take the plain route (its counter moves, no
    kernel launches) and agree with the same EGCL at float64 on the CPU
    within TOL_FLAGS."""
    import torch
    from enflow_tpu_torch.data.system import System
    from enflow_tpu_torch.flow.integrators import FlowConfig, _egcl_at
    from enflow_tpu_torch.nn import egcl as egcl_mod
    from enflow_tpu_torch.nn.egcl import EGCLConfig, init_egcl
    from enflow_tpu_torch.ops import edge_pipeline as ep
    from enflow_tpu_torch.ops import egcl_allpairs as ea

    B, N, nf, H = 16, 13, 5, 128
    gen = torch.Generator().manual_seed(23)
    ecfg = EGCLConfig(nf, H, attention=True, norm_diff=True, tanh=True)
    params = init_egcl(gen, ecfg, torch.float64, "cpu")
    for mode, box_len, r_cut, cap in (("all_pairs", 1e3, 1e2, None),
                                      ("images", 4.0, 2.5, 64)):
        pos = torch.rand((B, N, 3), generator=gen, dtype=torch.float64)
        pos = (pos - 0.5) * min(box_len, 3.0)
        sys64 = System(h=torch.randn((B, N, nf), generator=gen,
                                     dtype=torch.float64),
                       g=torch.zeros((B, N, nf), dtype=torch.float64),
                       pos=pos, vel=torch.zeros_like(pos),
                       mask=torch.ones((B, N), dtype=torch.bool),
                       box=torch.full((B, 3), box_len, dtype=torch.float64),
                       r_cut=torch.full((B,), r_cut, dtype=torch.float64))
        cfg = FlowConfig(n_iter=1, dt=0.1, egcl=ecfg, nbr_mode=mode,
                         nbr_capacity=cap)
        want, _ = _egcl_at(None, cfg, params, sys64)
        to_card = lambda t: t.to(device="cuda", dtype=torch.float32
                                 if t.is_floating_point() else t.dtype)
        card_sys = System(**{f: to_card(getattr(sys64, f)) for f in (
            "h", "g", "pos", "vel", "mask", "box", "r_cut")})
        tree = lambda t: ({k: tree(v) for k, v in t.items()}
                          if isinstance(t, dict) else [tree(v) for v in t]
                          if isinstance(t, list) else to_card(t))
        card_params = tree(params)
        reset_counts()
        got, ovf = _egcl_at(None, cfg, card_params, card_sys)
        torch.cuda.synchronize()
        launches = (ea.counts.fwd_launches + ea.counts.bwd_launches
                    + ep.counts.fwd_launches + ep.counts.bwd_launches)
        errs = rel_errs(("Q", "F", "G"), got, [to_card(w) for w in want])
        ok = all(r <= TOL_FLAGS for _, r in errs.values())
        phase("flags", f"{mode} f32 B={B} N={N} attention+norm_diff+tanh: "
              f"plain-route calls {egcl_mod.counts.plain_calls}, kernel "
              f"launches {launches}, overflow {int(ovf)}; vs CPU float64 "
              "max_abs/rel err: " + "  ".join(
                  f"{n} {a:.2e}/{r:.1e}" for n, (a, r) in errs.items())
              + f"  tol {TOL_FLAGS:g} -> {'ok' if ok else 'FAIL'}")
        require(egcl_mod.counts.plain_calls == 1 and launches == 0,
                "the flagged EGCL did not take the plain route")
        require(int(ovf) == 0, "the images neighbor list overflowed")
        require(ok, f"the flagged EGCL on the card disagrees with float64 "
                f"({mode})")


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
  network: {{hidden_nf: {hidden}, node_nf: {node}, use_pallas: v3}}
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


def smc_driver(tmp, hidden=128, node=5):
    """The port's driver, set up from ``SMC_YAML`` written into ``tmp``
    (the network at ``hidden_nf`` ``hidden`` and ``node_nf`` ``node``)."""
    from enflow_tpu_torch.train.driver import Main
    from enflow_tpu_torch.utils.conversion import lj_to_time

    cfg = Path(tmp) / "smc_lj13.yaml"
    cfg.write_text(SMC_YAML.format(dt=lj_to_time(0.05, "pico"),
                                   out=str(Path(tmp) / "samples.npz"),
                                   hidden=hidden, node=node))
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


# Kineto drops a device record whose time falls outside the trace's window
# ("Out-of-range"), and more of them as the process ages, whatever it runs:
# a trace of 20 K5 launches with no margin kept 0 to 5 of them from 206 s
# on in an idle process (--trace-check 3 8, margins then 0.025 s), with
# margins 20. Idle margins at both ends of the window stop that; they do
# not stop a trace that drops most of its launches now and then (0 of 20
# once at 75 s with 0.05 s margins), which device_ms's retries cover.
TRACE_MARGIN_S = 0.05


@contextlib.contextmanager
def device_trace(margin=TRACE_MARGIN_S):
    """A ``torch.profiler`` session tracing CUDA activity with ``margin``
    seconds idle at both ends of its window; the body's device work is
    synchronized before the closing margin."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(margin)
        yield prof
        torch.cuda.synchronize()
        time.sleep(margin)


def device_ms(fn, key, calls=20, tries=3, warmup=3):
    """Median device time of one kernel launch whose name holds ``key``
    (for a tuple of keys, the sum of each one's median, from one trace),
    over ``calls`` calls of ``fn`` traced by ``torch.profiler`` (after
    ``warmup`` warm-up calls). The trace may drop events: at least half of
    each key's launches must be in it, else the calls are traced again, up
    to ``tries`` times."""
    keys = key if isinstance(key, tuple) else (key,)
    return sum(device_ms_each(fn, keys, calls, tries, warmup))


def device_ms_each(fn, keys, calls=20, tries=3, warmup=3):
    """``device_ms``'s median for each of ``keys``, from one trace."""
    import torch
    from torch.autograd import DeviceType
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with device_trace() as prof:
            for _ in range(calls):
                fn()
        spans = [sorted(e.time_range.end - e.time_range.start
                        for e in prof.events()
                        if e.device_type == DeviceType.CUDA and k in e.name)
                 for k in keys]
        for k, ts in zip(keys, spans):
            require(len(ts) <= calls, f"{len(ts)} '{k}' launches traced of "
                    f"{calls} calls")
        if all(len(ts) >= calls // 2 for ts in spans):
            return [ts[len(ts) // 2] * 1e-3 for ts in spans]
    raise RuntimeError(f"{[len(ts) for ts in spans]} {keys} launches traced "
                       f"of {calls}, {tries} times")


def trace_probe(fn, key, margin, calls=20):
    """Launches whose name holds ``key`` in the raw trace of ``calls`` calls
    of ``fn`` traced as ``device_ms`` traces them, with ``margin`` seconds
    idle at each end of the window."""
    from torch.autograd import DeviceType
    with device_trace(margin=margin) as prof:
        for _ in range(calls):
            fn()
    return sum(e.device_type() == DeviceType.CUDA and key in e.name()
               for e in prof.profiler.kineto_results.events())


def trace_check(card, rounds, idle):
    """Why a device-time trace late in a run can hold too few launches: 20
    K5 launches at EDGE_SHAPES' main shape (bf16) traced with no margin and
    with TRACE_MARGIN_S, after the build; then after phase data (whose
    epoch runs under the port's ``profile_trace``, whose NaN-guarded epoch
    raises) and after phase import, ``rounds`` times; then after each of
    ``idle`` minutes in which the process does nothing. Fails if a trace
    with the margins held fewer than the half that ``device_ms`` needs."""
    import torch
    from enflow_tpu_torch.ops import edge_pipeline as ep
    e, cd, em, W, _, _, _ = gathered_inputs(EDGE_SHAPES["main"],
                                            torch.bfloat16, seed=13)
    fwd = lambda: ep.edge_pipeline_fwd(e, cd, em, W)  # noqa: E731
    for _ in range(3):
        fwd()
    t0 = time.perf_counter()
    short = []

    def probe(label):
        bare, kept = (trace_probe(fwd, "fwd_kernel", m)
                      for m in (0.0, TRACE_MARGIN_S))
        phase("trace", f"{label} ({time.perf_counter() - t0:.1f} s): K5 "
              f"launches traced of 20: {bare} with no margin, {kept} with "
              f"{TRACE_MARGIN_S} s margins")
        if kept < 10:
            short.append(label)

    probe("after the build")
    for r in range(rounds):
        with tempfile.TemporaryDirectory() as tmp:
            data_phase(card, tmp)
            probe(f"round {r} after data")
            import_phase(card, tmp)
            probe(f"round {r} after import")
    for m in range(idle):
        time.sleep(60)
        probe(f"idle minute {m + 1}")
    phase("trace", f"on {card}: traces with margins holding fewer than 10 "
          f"launches: {short}")
    require(not short, f"traces with margins lost half the launches: "
            f"{short}")


def host_ms(fn, calls=200):
    """Host time of one call of ``fn``: ``calls`` calls back to back with
    no synchronize between them (the wrapper's own work, where the device
    work of a call is shorter)."""
    import torch
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / calls * 1e3


def ab_phase(card, old_src):
    """An earlier kernel source against the current one, in turns old,
    new, new, old, old, new within this process. ``old_src`` is an
    earlier egcl_allpairs_f32.cu (``f32_bits_ab_phase``),
    egcl_allpairs_xwide.cu (``xwide_bits_ab_phase``), edge_pipeline.cu
    (``edge_ab_phase``), edge_pipeline_sm90.cu (``edge_sm90_bits_ab_phase``),
    pair_energy.cu (``pair_ab_phase``) or egcl_allpairs_sm90.cu with the same bf16 K1/K2 entry points (K2 p and
    the VI path stay on the current source). For the last a turn times
    K1 and the input-gradient K2 at the main-path shape with CUDA events
    and device time, then three SMC runs of phase 7 after a warm-up (the
    path is host-bound and its times drift between turns by more than the
    kernels move them)."""
    import ctypes
    import os
    import torch
    from enflow_tpu_torch.ops import build
    from enflow_tpu_torch.ops import egcl_allpairs as ops

    text = Path(old_src).read_text()
    edge = "edge_tiled_fwd" in text
    hopper = "egcl_sm90_fwd" in text
    pair = "pair_energy_kernel" in text
    tiled_f32 = "egcl_f32_fwd" in text
    edge_sm90 = "edge_sm90_fwd" in text
    xwide = "egcl_xwide_fwd" in text
    with tempfile.TemporaryDirectory() as tmp:
        lib_path = Path(tmp) / "libegcl_old.so"
        t0 = time.perf_counter()
        out = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-I",
                              str(build.CSRC), "-o", str(lib_path),
                              str(old_src)], capture_output=True, text=True)
        require(out.returncode == 0, f"nvcc failed on {old_src}:\n"
                f"{out.stdout}{out.stderr}")
        old_lib = ctypes.CDLL(str(lib_path))
    require(edge or hopper or pair or tiled_f32 or edge_sm90 or xwide,
            f"{old_src}: not a kernel source that --ab compares")
    kind = ("edge-pipeline" if edge else "Hopper" if hopper
            else "pair-energy" if pair else "tiled f32" if tiled_f32
            else "column-chunked all-pairs" if xwide
            else "Hopper edge-pipeline")
    phase("ab", f"built {old_src} ({kind} kernels) in "
          f"{time.perf_counter() - t0:.1f} s")
    if tiled_f32:
        f32_bits_ab_phase(card, old_lib)
        return
    if xwide:
        xwide_bits_ab_phase(card, old_lib)
        return
    if edge_sm90:
        edge_sm90_bits_ab_phase(card, old_lib)
        return
    if edge:
        edge_ab_phase(card, old_lib)
        return
    if pair:
        pair_ab_phase(card, old_lib)
        return
    new_lib = ops._sm90_library()
    params = "egcl_sm90_bwd_params" in text
    blocks = "egcl_sm90_blocks_fwd" in text
    for fn in ("egcl_sm90_fwd", "egcl_sm90_bwd", "egcl_sm90_smem_bytes",
               "egcl_sm90_smem_limit", "egcl_sm90_error_string") + ((
                   "egcl_sm90_bwd_params", "egcl_sm90_param_slices",
                   "egcl_sm90_slice_floats", "egcl_part_size")
                   if params else ()) + ((
                       "egcl_sm90_blocks_fwd", "egcl_sm90_blocks_bwd",
                       "egcl_sm90_blocks_bwd_params",
                       "egcl_sm90_blocks_smem_bytes",
                       "egcl_sm90_blocks_param_slices") if blocks else ()):
        f, g = getattr(old_lib, fn), getattr(new_lib, fn)
        f.argtypes, f.restype = g.argtypes, g.restype
    old_lib._enflow_bound = True

    def use(which):
        build._loaded["egcl_allpairs_sm90"] = (old_lib if which == "old"
                                               else new_lib)

    # the two sources' one-molecule kernels bit for bit, at the shapes of
    # phases kernel and params and at each direction's largest molecule
    cases = []
    for sname, shape in (("main", MAIN), ("ragged", RAGGED), ("vi", VI),
                         ("ico", ICO), ("h64", H64),
                         ("n55", dict(B=64, N=55, nf=5, H=128)),
                         ("n61", dict(B=64, N=61, nf=5, H=128)),
                         ("n111", dict(B=64, N=111, nf=5, H=128)),
                         ("n1", dict(B=5, N=1, nf=5, H=128))):
        args = edge_inputs(shape, torch.bfloat16, seed=11)[:7]
        for kind in ("fwd", "bwd") + (("bwd_params",) if params else ()):
            if shape["N"] > ops.largest_molecule(1, 5, shape["H"], kind):
                continue
            run = ((lambda: ops.allpairs_edges_fwd(*args[:5]))
                   if kind == "fwd" else (lambda p=kind == "bwd_params":
                                          ops.allpairs_edges_bwd(*args,
                                                                 params=p)))
            use("old")
            a = run()
            use("new")
            same = all(bool(torch.equal(x, y)) for x, y in zip(a, run()))
            cases.append((f"{sname} {kind}", same))
    # the block-pair kernels at H = 64 and 128 (their own route past the
    # one-molecule limits; launched through allpairs_edges_blocks within
    # them) and at 192 / 256 (route "wide", every N) where the earlier
    # source streams W2 / W3
    wide = "streamed(H)" in text
    for sname, shape in ((("blocks lj147", dict(B=16, N=147, nf=5, H=128,
                                                 n_pad=2)),
                           ("blocks n60", dict(B=32, N=60, nf=5, H=128)),
                           ("blocks h64 n100", dict(B=16, N=100, nf=5,
                                                    H=64)))
                          if blocks else ()) + ((
                              ("wide h192 n13", dict(B=32, N=13, nf=5,
                                                     H=192)),
                              ("wide h256 n55", dict(B=8, N=55, nf=5, H=256,
                                                     n_pad=2)))
                              if wide else ()):
        args = edge_inputs(shape, torch.bfloat16, seed=11)[:7]
        for kind in ("fwd", "bwd", "bwd_params"):
            run = lambda k=kind: ops.allpairs_edges_blocks(
                k, *(args[:5] if k == "fwd" else args))
            use("old")
            a = run()
            use("new")
            same = all(bool(torch.equal(x, y)) for x, y in zip(a, run()))
            cases.append((f"{sname} {kind}", same))
        torch.cuda.empty_cache()
    differ = [c for c, same in cases if not same]
    phase("ab", f"old == new bit for bit at {len(cases) - len(differ)} of "
          f"{len(cases)} shape x direction cases"
          + (" (one-molecule and block-pair kernels)" if blocks else "")
          + (f"; they differ at {differ}" if differ else ""))

    h, pos, box, mask_f, W, dagg, dfsum, _ = edge_inputs(MAIN, torch.bfloat16,
                                                         seed=11)
    fwd = lambda: ops.allpairs_edges_fwd(h, pos, box, mask_f, W)
    bwd = lambda: ops.allpairs_edges_bwd(h, pos, box, mask_f, W, dagg, dfsum)
    cwd, rows = os.getcwd(), []
    try:
        with tempfile.TemporaryDirectory() as tmp:
            main = smc_driver(tmp)
            for which in ("old", "new", "new", "old", "old", "new"):
                use(which)
                _, errs = kernel_errs(ops, h, pos, box, mask_f, W, dagg,
                                      dfsum)
                require(all(r <= TOL["bfloat16"] for _, r in errs.values()),
                        f"{which} kernels disagree with plain: {errs}")
                t = dict(fwd=cuda_time_ms(fwd), bwd=cuda_time_ms(bwd),
                         fwd_dev=device_ms(fwd, "fwd_kernel"),
                         bwd_dev=device_ms(bwd, "bwd_kernel"))
                main.sample()                               # warm-up
                secs = []
                for _ in range(3):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    res = main.sample()
                    torch.cuda.synchronize()
                    secs.append(time.perf_counter() - t0)
                require(float(res.beta_history[-1]) > 1.0 - 1e-5,
                        "anneal did not reach beta = 1")
                t["smc"] = secs
                rows.append((which, t))
                phase("ab", f"{which} on {card}: K1 {t['fwd']:.4f} ms "
                      f"(device {t['fwd_dev']:.4f}), K2 {t['bwd']:.4f} ms "
                      f"(device {t['bwd_dev']:.4f}); SMC runs "
                      + ", ".join(f"{x:.4f}" for x in secs) + " s")
    finally:
        use("new")
        os.chdir(cwd)
    for key in rows[0][1]:
        pick = lambda which: statistics.median(
            x for w, t in rows if w == which
            for x in (t[key] if key == "smc" else [t[key]]))
        old, new = pick("old"), pick("new")
        unit = "s/run" if key == "smc" else "ms"
        phase("ab", f"{key} (median): old {old:.5f} new {new:.5f} {unit} -> "
              f"{old / new:.2f}x" + (f"; {1024 / old:.1f} -> {1024 / new:.1f}"
                                     " samples/s" if key == "smc" else ""))


def ab_turns(card, use, timers):
    """Turns old, new, new, old, old, new of ``timers`` ({name: (fn, device
    key)}: CUDA events and device time of one call each), then each
    median's old / new."""
    rows = []
    for which in ("old", "new", "new", "old", "old", "new"):
        use(which)
        t = {}
        for name, (fn, key) in timers.items():
            t[name] = cuda_time_ms(fn, reps=10, calls=3)
            t[name + " device"] = device_ms(fn, key, calls=10)
        rows.append((which, t))
        phase("ab", f"{which} on {card}: " + ", ".join(
            f"{k} {v:.4f} ms" for k, v in t.items()))
    use("new")
    for key in rows[0][1]:
        pick = lambda which: statistics.median(
            t[key] for w, t in rows if w == which)
        old, new = pick("old"), pick("new")
        phase("ab", f"{key} (median): old {old:.5f} new {new:.5f} ms -> "
              f"{old / new:.3f}x")


def f32_bits_ab_phase(card, old_lib):
    """An earlier egcl_allpairs_f32.cu (``old_lib``, built) against the
    current one's one-molecule kernels: f32 K1, K2 and K2 p bit for bit at
    the main, ragged, VI, DW4 and ala2 shapes and at each direction's
    largest molecule (nf=5, H=128); where the earlier source has them, its
    block-pair kernels at H = 128 (N = 147 and 75) and 64 (N = 100) in
    every direction (through ``allpairs_edges_blocks``); then timed in
    turns (ala2's K1 and K2 p, sample_ala2's K2 at B=2048; CUDA events and
    device time). Where the earlier source streams W2 / W3 (route
    ``"f32_wide"``), its block pairs at H = 192 (N=22, nf=4) and 256 (N=55)
    too."""
    import torch
    from enflow_tpu_torch.ops import build
    from enflow_tpu_torch.ops import egcl_allpairs as ops

    new_lib = ops._f32_library()
    blocks = hasattr(old_lib, "egcl_f32_blocks_fwd")
    for fn in ("egcl_f32_fwd", "egcl_f32_bwd", "egcl_f32_bwd_params",
               "egcl_f32_smem_bytes", "egcl_f32_smem_limit",
               "egcl_f32_error_string", "egcl_part_size") + ((
                   "egcl_f32_blocks_fwd", "egcl_f32_blocks_bwd",
                   "egcl_f32_blocks_bwd_params",
                   "egcl_f32_blocks_smem_bytes") if blocks else ()):
        f, g = getattr(old_lib, fn), getattr(new_lib, fn)
        f.argtypes, f.restype = g.argtypes, g.restype
    old_lib._enflow_bound = True
    # the streamed widths: the earlier library takes H = 256 block pairs
    wide = blocks and old_lib.egcl_f32_blocks_smem_bytes(8, 5, 256, 8, 0) > 0

    def use(which):
        build._loaded["egcl_allpairs_f32"] = (old_lib if which == "old"
                                              else new_lib)

    big = {k: ops.largest_molecule(0, 5, 128, k)
           for k in ("fwd", "bwd", "bwd_params")}
    cases = []
    for sname, shape, kinds in (
            ("main", MAIN, None), ("ragged", RAGGED, None), ("vi", VI, None),
            ("dw4", DW4, None), ("ala2", ALA2, None),
            ("n1", dict(B=5, N=1, nf=5, H=128), None),
            ("fwd max", dict(B=4, N=big["fwd"], nf=5, H=128), ("fwd",)),
            ("bwd max", dict(B=2, N=big["bwd"], nf=5, H=128), ("bwd",)),
            ("bwd_params max", dict(B=4, N=big["bwd_params"], nf=5, H=128),
             ("bwd_params",))):
        args = edge_inputs(shape, torch.float32, seed=11)[:7]
        for kind in kinds or ("fwd", "bwd", "bwd_params"):
            run = ((lambda: ops.allpairs_edges_fwd(*args[:5]))
                   if kind == "fwd" else (lambda p=kind == "bwd_params":
                                          ops.allpairs_edges_bwd(*args,
                                                                 params=p)))
            use("old")
            a = run()
            use("new")
            same = all(bool(torch.equal(x, y)) for x, y in zip(a, run()))
            cases.append((f"{sname} {kind}", same))
        torch.cuda.empty_cache()
    # the block-pair kernels at the resident widths (their route past the
    # tiled limits; launched through allpairs_edges_blocks within them)
    for sname, shape in ((("blocks lj147", dict(B=16, N=147, nf=5, H=128,
                                                 n_pad=2)),
                           ("blocks n75", dict(B=8, N=75, nf=5, H=128)),
                           ("blocks h64 n100", dict(B=8, N=100, nf=5,
                                                    H=64)))
                          if blocks else ()) + ((
                              ("wide h192 n22", dict(B=16, N=22, nf=4,
                                                     H=192)),
                              ("wide h256 n55", dict(B=4, N=55, nf=5, H=256,
                                                     n_pad=2)))
                              if wide else ()):
        args = edge_inputs(shape, torch.float32, seed=11)[:7]
        for kind in ("fwd", "bwd", "bwd_params"):
            run = lambda k=kind: ops.allpairs_edges_blocks(
                k, *(args[:5] if k == "fwd" else args))
            use("old")
            a = run()
            use("new")
            same = all(bool(torch.equal(x, y)) for x, y in zip(a, run()))
            cases.append((f"{sname} {kind}", same))
        torch.cuda.empty_cache()
    differ = [c for c, same in cases if not same]
    phase("ab", "f32 one-molecule" + (" and block-pair" if blocks else "")
          + f" kernels: old == new bit for bit at "
          f"{len(cases) - len(differ)} of {len(cases)} shape x direction "
          "cases" + (f"; they differ at {differ}" if differ else ""))
    require(not differ, f"the f32 kernels changed: {differ}")
    args = edge_inputs(ALA2, torch.float32, seed=37)[:7]
    args2 = edge_inputs(dict(ALA2, B=2048), torch.float32, seed=41)[:7]
    ab_turns(card, use, {
        "K1 ala2": (lambda: ops.allpairs_edges_fwd(*args[:5]),
                    "egcl_f32_fwd"),
        "K2 p ala2": (lambda: ops.allpairs_edges_bwd(*args, params=True),
                      "egcl_f32_bwd_params"),
        "K2 B=2048": (lambda: ops.allpairs_edges_bwd(*args2),
                      "egcl_f32_bwd_kernel")})


def xwide_bits_ab_phase(card, old_lib):
    """An earlier egcl_allpairs_xwide.cu (``old_lib``, built; the entry
    points of this one) against the current at H = 320, 512 and 1024 x N =
    13, 55 and 147 (phase xwide's batches): the float32 K1, K2 and K2 p and
    the bf16 K2 p bit for bit; the bf16 K1 and K2 (the ring kernels here,
    whose gate and dr2 sums may take another order) counted where they give
    the same bits, each held to phase xwide (a)'s limits against the plain
    version. Then K1 / K2 of both dtypes at the reference's B=1024, N=13,
    H=512 and the bf16 K1 / K2 at B=256, N=55 timed in turns (CUDA events
    and device time)."""
    import torch
    from enflow_tpu_torch.ops import build
    from enflow_tpu_torch.ops import egcl_allpairs as ops

    new_lib = ops._xwide_library()
    for fn in ("egcl_xwide_fwd", "egcl_xwide_bwd", "egcl_xwide_bwd_params",
               "egcl_xwide_grid", "egcl_xwide_splits", "egcl_xwide_threads",
               "egcl_xwide_max_width", "egcl_xwide_smem_bytes",
               "egcl_xwide_smem_limit", "egcl_part_size",
               "egcl_xwide_error_string"):
        f, g = getattr(old_lib, fn), getattr(new_lib, fn)
        f.argtypes, f.restype = g.argtypes, g.restype
    if not hasattr(old_lib, "egcl_xwide_tiles"):
        # a library before the ring kernels: five tiles a block everywhere
        old_lib.egcl_xwide_tiles = lambda code, kind: 5
    old_lib._enflow_bound = True

    def use(which):
        build._loaded["egcl_allpairs_xwide"] = (old_lib if which == "old"
                                                else new_lib)

    cases, ring = [], []
    for dname in ("bfloat16", "float32"):
        for H in (320, 512, 1024):
            for N in XWIDE_NS:
                shape = dict(B=XWIDE_CHECK_B[N], N=N, nf=5, H=H, n_pad=1)
                args = edge_inputs(shape, getattr(torch, dname), seed=11)[:7]
                for kind in ("fwd", "bwd", "bwd_params"):
                    run = lambda k=kind: ops.allpairs_edges_xwide(
                        k, *(args[:5] if k == "fwd" else args))
                    use("old")
                    a = run()
                    use("new")
                    b = run()
                    same = all(bool(torch.equal(x, y))
                               for x, y in zip(a, b))
                    label = f"{dname} H={H} N={N} {kind}"
                    if dname == "bfloat16" and kind != "bwd_params":
                        want = (ops.allpairs_edges_plain(*args[:5])
                                if kind == "fwd" else
                                ops.allpairs_edges_plain_bwd(*args))
                        ok, text, _ = xwide_reading(b, want, args, dname,
                                                    kind)
                        require(ok, f"{label} (new) disagrees with plain: "
                                f"{text}")
                        ring.append((label, same))
                    else:
                        cases.append((label, same))
                    del a, b
                torch.cuda.empty_cache()
    use("new")
    differ = [c for c, same in cases if not same]
    phase("ab", f"column-chunked all-pairs f32 K1/K2/K2 p and bf16 K2 p: "
          f"old == new bit for bit at {len(cases) - len(differ)} of "
          f"{len(cases)} dtype x shape x direction cases"
          + (f"; they differ at {differ}" if differ else ""))
    require(not differ, f"the all-pairs xwide kernels changed: {differ}")
    apart = [c for c, same in ring if not same]
    phase("ab", f"bf16 K1/K2: old == new bit for bit at "
          f"{len(ring) - len(apart)} of {len(ring)} shape x direction cases"
          + (f"; the others ({apart}) within phase xwide (a)'s limits of "
             "the plain version" if apart else "") + "; every new launch "
          "within them")
    ref = dict(B=1024, N=13, nf=5, H=XWIDE_H)
    args = edge_inputs(ref, torch.bfloat16, seed=11)[:7]
    f32 = edge_inputs(ref, torch.float32, seed=11)[:7]
    lj55 = edge_inputs(dict(B=256, N=55, nf=5, H=XWIDE_H), torch.bfloat16,
                       seed=11)[:7]
    ab_turns(card, use, {
        "K1 ref512": (lambda: ops.allpairs_edges_fwd(*args[:5]),
                      "egcl_xwide_kernel"),
        "K2 ref512": (lambda: ops.allpairs_edges_bwd(*args),
                      "egcl_xwide_kernel"),
        "K1 lj55": (lambda: ops.allpairs_edges_fwd(*lj55[:5]),
                    "egcl_xwide_kernel"),
        "K2 lj55": (lambda: ops.allpairs_edges_bwd(*lj55),
                    "egcl_xwide_kernel"),
        "K1 f32 ref512": (lambda: ops.allpairs_edges_fwd(*f32[:5]),
                          "egcl_xwide_kernel"),
        "K2 f32 ref512": (lambda: ops.allpairs_edges_bwd(*f32),
                          "egcl_xwide_kernel")})


def edge_sm90_bits_ab_phase(card, old_lib):
    """An earlier edge_pipeline_sm90.cu (``old_lib``, built; the entry
    points of this one at H = 64 and 128) against the current: bf16 K5
    and K6 bit for bit at every EDGE_SHAPES shape that runs them at its own
    width, then timed in turns at the top-k sampler's shape (CUDA events
    and device time)."""
    import torch
    from enflow_tpu_torch.ops import build
    from enflow_tpu_torch.ops import edge_pipeline as ep

    new_lib = ep._sm90_library()
    for fn in ("edge_sm90_fwd", "edge_sm90_bwd", "edge_sm90_error_string",
               "edge_sm90_recip_check", "edge_sm90_warpgroups",
               "edge_sm90_c_max"):
        f, g = getattr(old_lib, fn), getattr(new_lib, fn)
        f.argtypes, f.restype = g.argtypes, g.restype
    old_lib._enflow_bound = True

    def use(which):
        build._loaded["edge_pipeline_sm90"] = (old_lib if which == "old"
                                               else new_lib)

    cases = []
    for sname, shape in edge_ab_shapes("bfloat16"):
        e, cd, em, W, dagg, dfs, _ = gathered_inputs(shape, torch.bfloat16,
                                                     seed=13)
        run = lambda: (ep.edge_pipeline_fwd(e, cd, em, W)
                       + ep.edge_pipeline_bwd(e, cd, em, W, dagg, dfs))
        use("old")
        a = run()
        use("new")
        b = run()
        cases.append((sname, all(bool(torch.equal(x, y))
                                 for x, y in zip(a, b))))
    use("new")
    differ = [c for c, same in cases if not same]
    phase("ab", f"bf16 K5/K6 at H = 64/128 and 192/256: old == new bit for "
          f"bit at {len(cases) - len(differ)} of {len(cases)} shapes (K5 and "
          "K6 outputs each)" + (f"; they differ at {differ}" if differ
                                else ""))
    require(not differ, f"the bf16 K5/K6 up to H = 256 changed: {differ}")
    e, cd, em, W, dagg, dfs, _ = gathered_inputs(EDGE_SHAPES["sampler"],
                                                 torch.bfloat16, seed=13)
    ab_turns(card, use, {
        "K5 sampler": (lambda: ep.edge_pipeline_fwd(e, cd, em, W),
                       "edge_sm90_fwd_kernel"),
        "K6 sampler": (lambda: ep.edge_pipeline_bwd(e, cd, em, W, dagg, dfs),
                       "edge_sm90_bwd_kernel")})


def edge_ab_shapes(dname):
    """The K5/K6 shapes that an A/B of an edge source holds bit for bit in
    ``dname``: EDGE_SHAPES at their own widths of 64 and 128, and
    EDGE_WIDE_SHAPES at 192 and 256 (each within its ``widths``), every
    one on the route of its width (its C within that route's limits)."""
    from enflow_tpu_torch.ops import edge_pipeline as ep
    out = [(s, shape) for s, shape in EDGE_SHAPES.items()
           if dname in shape.get("dtypes", (dname,))
           and shape["H"] in ep.TILED_H]
    for H in ep.WIDE_H:
        for s, base in EDGE_WIDE_SHAPES.items():
            if (dname in base.get("dtypes", (dname,))
                    and H in base.get("widths", (H,))
                    and not base.get("fwd_only")):
                out.append((f"{s} H={H}", dict(base, H=H)))
    return out


def edge_ab_phase(card, old_lib):
    """An earlier edge_pipeline.cu (``old_lib``, built; its tiled f32
    entry points) against the current: f32 K5 and K6 bit for bit at every
    EDGE_SHAPES shape that runs the tiled kernels at its own width (H = 64
    and 128), then in turns old, new, new, old, old, new within this
    process: K5 and K6 at EDGE_AB (the training shape and the ragged one)
    with CUDA events and device time, then one train.yaml epoch (after a
    warm-up epoch before the first turn)."""
    import os
    import torch
    from enflow_tpu_torch.ops import build
    from enflow_tpu_torch.ops import edge_pipeline as ep

    new_lib = ep._library()
    ep.bind_library(old_lib)

    def use(which):
        build._loaded["edge_pipeline"] = (old_lib if which == "old"
                                          else new_lib)

    same, cases = [], {}
    for sname, shape in edge_ab_shapes("float32"):
        e, cd, em, W, dagg, dfs, _ = gathered_inputs(shape, torch.float32,
                                                      13)
        fwd = lambda e=e, cd=cd, em=em, W=W: ep.edge_pipeline_fwd(e, cd, em,
                                                                   W)
        bwd = (lambda e=e, cd=cd, em=em, W=W, dagg=dagg, dfs=dfs:
               ep.edge_pipeline_bwd(e, cd, em, W, dagg, dfs))
        use("old")
        a = fwd() + bwd()
        use("new")
        b = fwd() + bwd()
        same.append((sname, all(bool(torch.equal(x, y))
                                for x, y in zip(a, b))))
        if sname in EDGE_AB:
            cases[sname] = (fwd, bwd, ep.edge_pipeline_plain(e, cd, em, *W)
                            + ep.edge_pipeline_plain_bwd(e, cd, em, *W, dagg,
                                                         dfs))
    differ = [c for c, ok in same if not ok]
    phase("ab", f"f32 K5/K6 at H = 64/128 and 192/256: old == new bit for "
          f"bit at {len(same) - len(differ)} of {len(same)} shapes (K5 and "
          "K6 outputs each)" + (f"; they differ at {differ}" if differ
                                else ""))
    require(not differ, f"the f32 K5/K6 up to H = 256 changed: {differ}")
    cwd, rows = os.getcwd(), []
    try:
        with tempfile.TemporaryDirectory() as tmp:
            main = train_driver(tmp, 1)
            main.train()                                    # warm-up
            main.start_epoch += 1
            for which in ("old", "new", "new", "old", "old", "new"):
                use(which)
                t, line = {}, []
                for key, (fwd, bwd, want) in cases.items():
                    errs = rel_errs(EDGE_OUT, fwd() + bwd(), want)
                    tol = {n: (TOL_EDGE if n in EDGE_OUT[:4]
                               else TOL_PARAM)["float32"] for n in EDGE_OUT}
                    require(all(errs[n][1] <= tol[n] for n in EDGE_OUT),
                            f"{which} K5/K6 disagree with plain at {key}: "
                            f"{errs}")
                    t.update({
                        f"{key} fwd": cuda_time_ms(fwd),
                        f"{key} bwd": cuda_time_ms(bwd),
                        f"{key} fwd_dev": device_ms(fwd, "fwd_kernel"),
                        f"{key} bwd_dev": device_ms(bwd, "bwd_kernel")})
                    line.append(
                        f"{key}: K5 {t[key + ' fwd']:.4f} ms (device "
                        f"{t[key + ' fwd_dev']:.4f}), K6 "
                        f"{t[key + ' bwd']:.4f} ms (device "
                        f"{t[key + ' bwd_dev']:.4f})")
                os.chdir(tmp)
                reset_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                main.train()
                torch.cuda.synchronize()
                t["train"] = (time.perf_counter() - t0) / TRAIN_STEPS_PER_EPOCH
                main.start_epoch += 1
                routes = edge_routes()
                require(routes["tiled"][1] > 0 and routes == route_counts(
                    "tiled", *routes["tiled"]),
                    f"{which} turn: K5/K6 launches by kernel {routes}")
                rows.append((which, t))
                phase("ab", f"{which} on {card}: " + "; ".join(line)
                      + f"; train.yaml {t['train']:.5f} s/step (one epoch "
                      f"of {TRAIN_STEPS_PER_EPOCH})")
    finally:
        use("new")
        os.chdir(cwd)
    for key in rows[0][1]:
        pick = lambda which: statistics.median(
            t[key] for w, t in rows if w == which)
        old, new = pick("old"), pick("new")
        unit = "s/step" if key == "train" else "ms"
        phase("ab", f"{key} (median): old {old:.5f} new {new:.5f} {unit} -> "
              f"{old / new:.2f}x")


def pair_ab_phase(card, old_lib):
    """An earlier pair_energy.cu (``old_lib``, built; its entry point
    takes no plan and leaves E per row tile for the wrapper to sum)
    against the current one, in turns old, new, new, old, old,
    new within this process: in an old turn every K7 call goes to the old
    source. A turn times K7 at PAIR_AB (form r at B=1, N=13; r2 at B=30,
    N=13; r at generate.yaml's 2,944 atoms), CUDA events and device time,
    then the MD of one train.yaml dataset (4,300 form-r calls) from a fresh
    working directory."""
    import ctypes
    import os
    import torch
    from enflow_tpu_torch.ops import build
    from enflow_tpu_torch.ops import pair_energy as pe

    _P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    old_lib.pair_energy.argtypes = [_I, _I, _I, _P, _P, _P, _F, _F, _I, _P,
                                    _P, _P]
    old_lib.pair_energy.restype = _I
    old_lib.pair_energy_row_tiles.argtypes = [_I]
    old_lib.pair_energy_row_tiles.restype = _I

    def old_launch(pos, mask_f, box, form, softening, cutoff, coincident):
        B, N, _ = pos.shape
        tiles = old_lib.pair_energy_row_tiles(N)
        e_part = torch.empty((B, tiles), dtype=torch.float32,
                             device=pos.device)
        grad = torch.empty((B, N, 3), dtype=torch.float32, device=pos.device)
        args = [t.contiguous() for t in (pos, mask_f, box)]
        err = old_lib.pair_energy(
            pe.FORMS[form], B, N, *[t.data_ptr() for t in args],
            float(softening), float(cutoff) ** 2 if form == "r" else 0.0,
            int(bool(coincident)), e_part.data_ptr(), grad.data_ptr(),
            torch.cuda.current_stream(pos.device).cuda_stream)
        require(err == 0, f"the old pair_energy kernel failed ({err})")
        setattr(pe.counts, f"{form}_launches",
                getattr(pe.counts, f"{form}_launches") + 1)
        return (e_part[:, 0] if tiles == 1 else e_part.sum(dim=1)), grad

    new_launch = pe._launch

    def use(which):
        pe._launch = old_launch if which == "old" else new_launch

    cases = {}
    for sname in PAIR_AB:
        shape = PAIR_SHAPES[sname]
        pos, mask, box = pair_inputs(shape, seed=17)
        a = (pos, mask, box, shape["form"], shape["softening"],
             shape.get("cutoff"), shape.get("coincident", False))
        cases[sname] = (lambda a=a: pe.pair_energy_and_grad(*a),
                        pe.pair_energy_plain(*a), pe.pair_plan(
                            shape["B"], shape["N"],
                            build.multiprocessors(pos.device)))
    cwd, rows = os.getcwd(), []
    try:
        for which in ("old", "new", "new", "old", "old", "new"):
            use(which)
            t, line = {}, []
            for sname, (call, want, plan) in cases.items():
                errs = rel_errs(("E", "dE/dpos"), call(), want)
                require(all(r <= TOL_PAIR for _, r in errs.values()),
                        f"{which} K7 disagrees with plain at {sname}: "
                        f"{errs}")
                t[sname] = cuda_time_ms(call)
                t[sname + " dev"] = (device_ms(call, "pair_energy_kernel")
                                     if which == "old" else
                                     sum(pair_device_ms(call, plan)))
                line.append(f"{sname} {t[sname]:.4f} ms (device "
                            f"{t[sname + ' dev']:.4f})")
            with tempfile.TemporaryDirectory() as tmp, timed_md() as md:
                pe.counts.reset()
                train_driver(tmp, 1)
                os.chdir(cwd)
            require(pe.counts.r_launches == 4300 and len(md.seconds) == 1,
                    f"{which}: MD launches {pe.counts.r_launches}")
            t["md"] = md.seconds[0]
            rows.append((which, t))
            phase("ab", f"{which} on {card}: K7 " + "; ".join(line)
                  + f"; train.yaml MD {t['md']:.4f} s (4,300 form-r calls)")
    finally:
        use("new")
        os.chdir(cwd)
    for key in rows[0][1]:
        pick = lambda which: statistics.median(
            t[key] for w, t in rows if w == which)
        old, new = pick("old"), pick("new")
        unit = "s" if key == "md" else "ms"
        phase("ab", f"{key} (median): old {old:.5f} new {new:.5f} {unit} -> "
              f"{old / new:.2f}x")


def profile_run(label, warm_up, run, card, out_file=None, top=12):
    """``run()`` once under ``torch.profiler`` after ``warm_up()``,
    tracing the device only (the lightest trace that sees the kernels):
    device time by kernel, and the device's busy time and idle share of
    the traced run's wall time. The full table goes to ``out_file`` when
    one is given."""
    import torch
    from torch.autograd import DeviceType

    warm_up()
    torch.cuda.synchronize()
    with device_trace() as prof:
        t0 = time.perf_counter()
        run()
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
    ours = {k: v for k, v in by_name.items()
            if any(w in k for w in ("egcl_", "edge_", "pair_energy"))}
    ours_s = sum(t for _, t in ours.values()) * 1e-6
    phase("profile", f"{label} under torch.profiler on {card}: wall "
          f"{wall:.4f} s, device busy {busy_s:.4f} s (idle share "
          f"{1 - busy_s / wall:.3f}); device time {total_s:.4f} s in "
          f"{len(spans)} device events, of which the port's kernels "
          f"{ours_s:.4f} s ({sum(n for n, _ in ours.values())} launches) and "
          f"the other {len(by_name) - len(ours)} kinds "
          f"{total_s - ours_s:.4f} s")
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    for name, (n, t) in ranked[:top]:
        phase("profile", f"{t * 1e-3:9.3f} ms {n:6d}x  {name[:110]}")
    if out_file is None:
        return
    out_file = Path(out_file)
    out_file.parent.mkdir(parents=True, exist_ok=True)
    out_file.write_text(
        f"{card}\n{label}: wall {wall} s, device busy {busy_s} s\n\n"
        + "\n".join(f"{t:.1f} us {n}x {name}" for name, (n, t) in ranked)
        + "\n")


def profile_smc(card, out_file=None):
    """One SMC run of the sampling path (after a warm-up run)."""
    with tempfile.TemporaryDirectory() as tmp:
        main = smc_driver(tmp)
        profile_run("LJ13 flow-SMC", main.sample, main.sample, card,
                    out_file)


def profile_vi(card, out_file=None):
    """One epoch of vi_lj13.yaml (VI_STEPS steps, after a warm-up epoch)."""
    with tempfile.TemporaryDirectory() as tmp:
        main = vi_driver(tmp, 1)

        def epoch():
            main.train()
            main.start_epoch += 1
        profile_run(f"vi_lj13.yaml epoch ({VI_STEPS} steps)", epoch, epoch,
                    card, out_file)


def profile_train(card, out_file=None):
    """One train epoch of train.yaml (after a warm-up epoch)."""
    with tempfile.TemporaryDirectory() as tmp:
        main = train_driver(tmp, 1)

        def epoch():
            main.train()
            main.start_epoch += 1
        profile_run("train.yaml epoch (4 steps)", epoch, epoch, card,
                    out_file)


# the sampler runs that --profile-samplers traces: cuts of the committed
# configs' rounds, sweeps or steps, every width as committed
PROFILE_SAMPLERS = (("remc_lj13.yaml", dict(n_rounds=20, discard_rounds=10)),
                    ("ti_lj13.yaml", dict(n_samples=2, n_warmup=1)),
                    ("sample_lj13_mcmc.yaml", dict(n_samples=20,
                                                   n_warmup=10)))


def profile_samplers(card, out_file=None):
    """The samplers of phases mcmc, remc and ti (PROFILE_SAMPLERS) from a
    vi_lj13.yaml checkpoint of one epoch, then sample_ala2.yaml as
    committed from a vi_ala2.yaml checkpoint of one epoch of FF_STEPS
    steps, each traced after a warm-up run; each table to
    ``<FILE>.<config>``."""
    import os

    def table(config):
        return None if out_file is None else Path(
            f"{out_file}.{config.split('.')[0]}")

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        try:
            vi_driver(tmp, 1).train()
            for config, over in PROFILE_SAMPLERS:
                main = config_driver(tmp, config, over=over)
                label = config + " (" + ", ".join(
                    f"{k} {v}" for k, v in over.items()) + ")"
                profile_run(label, main.sample, main.sample, card,
                            table(config))
            config_driver(tmp, "vi_ala2.yaml", over=dict(
                num_epochs=1, steps_per_epoch=FF_STEPS)).train()
            main = config_driver(tmp, "sample_ala2.yaml")
            profile_run("sample_ala2.yaml as committed", main.sample,
                        main.sample, card, table("sample_ala2.yaml"))
        finally:
            os.chdir(cwd)


def profile_generate(card, out_file=None):
    """generate.yaml's flow (``Main.generate``: reverse, forward, reverse)
    after a warm-up one, from the checkpoint of a 1-epoch train.yaml run;
    then its MD cut to DATASET_STEPS steps (``mode: dataset``, no outputs)
    after a warm-up run. The MD's table goes to ``FILE.md``."""
    import contextlib
    import io
    import os
    import yaml
    from enflow_tpu_torch.train.driver import Main

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        try:
            train_driver(tmp, 1).train()
            src = ROOT / "example" / "generate.yaml"
            main, _ = generate_setup(src)

            def flow():
                with contextlib.redirect_stdout(io.StringIO()):
                    main.generate()
            profile_run("generate.yaml flow (reverse, forward, reverse; "
                        f"K = {main.flow_cfg.nbr_capacity})", flow, flow,
                        card, out_file)
            cfg = yaml.safe_load(src.read_text())
            cfg["mode"] = "dataset"
            for k in ("log", "traj"):
                cfg["dataset"].pop(k)
            cfg["dataset"].update(
                n_iter=DATASET_STEPS, node_nf=main.node_nf,
                temp=main.args["dataset"]["temp"], softening=main.softening)
            Path("md.yaml").write_text(yaml.safe_dump(cfg))

            def md():
                with contextlib.redirect_stdout(io.StringIO()):
                    Main(device="cuda")("md.yaml")
            profile_run(f"generate.yaml's MD cut to {DATASET_STEPS} steps "
                        "(+ 200 FIRE steps)", md, md, card,
                        f"{out_file}.md" if out_file else None)
        finally:
            os.chdir(cwd)


TRAIN_STEPS_PER_EPOCH = 4          # 91 frames in batches of 30


def train_driver(tmp, num_epochs):
    """The port's driver set up from ``example/train.yaml`` with
    ``num_epochs`` changed, run from the working directory ``tmp`` (where
    the processed dataset and the checkpoint go)."""
    import os
    import yaml
    from enflow_tpu_torch.train.driver import Main

    cfg = yaml.safe_load((ROOT / "example" / "train.yaml").read_text())
    cfg["training"]["num_epochs"] = num_epochs
    path = Path(tmp) / "train.yaml"
    path.write_text(yaml.safe_dump(cfg))
    os.chdir(tmp)
    main = Main(device="cuda")
    main.setup(str(path))
    return main


def reset_counts():
    from enflow_tpu_torch.nn import egcl
    from enflow_tpu_torch.ops import edge_pipeline, egcl_allpairs, pair_energy
    for mod in (egcl, egcl_allpairs, edge_pipeline, pair_energy):
        mod.counts.reset()


def train_phase(card, tmp):
    """The training path: ``example/train.yaml`` through the port's driver
    for 3 epochs in the working directory ``tmp`` (the LJ MD dataset
    simulated on the card, then NLL steps), then a rerun of 1 epoch that
    resumes from the checkpoint, which phase generate then reads."""
    import os
    import torch
    from enflow_tpu_torch.ops import edge_pipeline as ep
    from enflow_tpu_torch.ops import pair_energy as pe

    cwd = os.getcwd()
    try:
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with timed_md() as timed_run:
            main = train_driver(tmp, 3)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        md_s = timed_run.seconds
        md = (pe.counts.r_launches, pe.counts.r2_launches,
              pe.counts.plain_calls)
        n_frames, cap = len(main.dataset), main.flow_cfg.nbr_capacity
        # the MD: 200 FIRE steps + 4000 Langevin steps, one form-r
        # launch each (energy and gradient from one pass), and one per
        # captured frame's energy (4000 / 40 = 100 frames)
        require(md == (200 + 4000 + 100, 0, 0),
                f"dataset pair-energy launches (r, r2, plain) {md} != "
                f"(4300, 0, 0)")
        require(n_frames == 91, f"{n_frames} frames, expected 91")

        step_s, losses = [], []
        inner = main.train_step

        def timed(batch, gen):
            torch.cuda.synchronize()
            t = time.perf_counter()
            loss, ovf = inner(batch, gen)
            losses.append(float(loss))          # synchronizes
            step_s.append(time.perf_counter() - t)
            return loss, ovf
        main.train_step = timed
        reset_counts()
        main.train()
        torch.cuda.synchronize()
        n_steps = len(step_s)
        launches = dict(k5=ep.counts.fwd_launches,
                        k6=ep.counts.bwd_launches,
                        k7_r2=pe.counts.r2_launches,
                        k7_r=pe.counts.r_launches)
        plain = plain_calls()
        # per train step: one gathered-edge forward (K5) and backward
        # (K6) per flow step (5), and one NLL pair term (K7 r2; its
        # backward is ct * g, no launch)
        want = dict(k5=5 * n_steps, k6=5 * n_steps, k7_r2=n_steps,
                    k7_r=0)
        require(n_steps == 3 * TRAIN_STEPS_PER_EPOCH,
                f"{n_steps} train steps, expected 12")
        require(launches == want, f"train launches {launches} != {want}")
        require(plain == 0, "a plain version ran on the training path")
        require(all(math.isfinite(x) for x in losses),
                f"non-finite losses {losses}")
        require(Path("model.cpt").exists(), "no checkpoint written")
        require(Path("data/lj13/processed.torch.npz").exists(),
                "no processed dataset written")

        reset_counts()
        again = train_driver(tmp, 1)
        require(again.start_epoch == 3 and pe.counts.r_launches == 0,
                f"rerun did not resume at epoch 3 from the stored "
                f"dataset (start {again.start_epoch}, "
                f"{pe.counts.r_launches} MD launches)")
        again.train()
        torch.cuda.synchronize()
        require(ep.counts.fwd_launches == 5 * TRAIN_STEPS_PER_EPOCH,
                "the resumed epoch did not run through the kernel")
    finally:
        os.chdir(cwd)
    later = step_s[TRAIN_STEPS_PER_EPOCH:]
    per_epoch = [sum(later[i:i + TRAIN_STEPS_PER_EPOCH])
                 for i in range(0, len(later), TRAIN_STEPS_PER_EPOCH)]
    s_step = statistics.median(later)
    mol_s = n_frames / statistics.median(per_epoch)
    phase("train", f"train.yaml on {card}: {n_frames} frames, auto "
          f"capacity {cap}, MD {md_s[0]:.4f} s ({md[0]} form-r launches; "
          f"setup {setup_s:.4f} s in all); {n_steps} steps, "
          f"{s_step:.5f} s/step (median of epochs 1-2; first step {step_s[0]:.4f} s), {mol_s:.1f} "
          f"molecules/s, losses {losses[0]:.2f} -> {losses[-1]:.2f}; "
          f"launches per run K5 {launches['k5']} K6 {launches['k6']} K7 r2 "
          f"{launches['k7_r2']}, plain calls 0; rerun resumed at epoch 3")
    return dict(md_launches=md[0], md_s=md_s[0], s_step=s_step,
                mol_s=mol_s, capacity=cap, **launches)


# generate.yaml's MD: 200 FIRE steps and 10,000 Langevin steps, one K7 r
# launch each, and one per captured frame's energy (10,000 / 100 frames)
GEN_FRAMES = 10000 // 100
GEN_MD_LAUNCHES = 200 + 10000 + GEN_FRAMES
# mode dataset: generate.yaml's dataset section with n_iter cut to 1,000
DATASET_STEPS = 1000


class timed_md:
    """Within the block, each simulated dataset's MD (FIRE, thermalization
    and the Langevin loop, host clock after a synchronize) is timed into
    the list ``seconds``, and its whole ``process`` (the MD plus the
    frames' copy to the host, the log and the trajectory) into
    ``process_seconds``."""

    def __enter__(self):
        import torch
        from enflow_tpu_torch.data.simulated import SimulatedDataset
        from enflow_tpu_torch.sim import integrate
        self.seconds, self.process_seconds = [], []
        self.saved = [(SimulatedDataset, "process",
                       SimulatedDataset.process)] + [
            (integrate, n, getattr(integrate, n))
            for n in ("minimize_fire", "thermalize", "simulate")]

        def clocked(fn, first, into):
            def run(*a, **k):
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = fn(*a, **k)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t
                if first:
                    into.append(0.0)
                into[-1] += dt
                return out
            return run

        for (mod, name, fn), first in zip(self.saved[1:],
                                          (True, False, False)):
            setattr(mod, name, clocked(fn, first, self.seconds))
        SimulatedDataset.process = clocked(self.saved[0][2], True,
                                           self.process_seconds)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


def plain_calls():
    """Calls of any plain version since the counts were reset."""
    from enflow_tpu_torch.nn import egcl
    from enflow_tpu_torch.ops import edge_pipeline as ep
    from enflow_tpu_torch.ops import egcl_allpairs as ea
    from enflow_tpu_torch.ops import pair_energy as pe
    return (ep.counts.plain_fwd_calls + ep.counts.plain_bwd_calls
            + pe.counts.plain_calls + ea.counts.plain_fwd_calls
            + ea.counts.plain_bwd_calls + ea.counts.plain_bwd_param_calls
            + egcl.counts.plain_calls)


def generate_setup(path):
    """``Main.setup`` of the port's driver on ``path`` (its MD lines kept
    off the smoke test's output). A capacity check that refuses a later
    frame (``nbr_capacity: auto`` sizes from frame 0 only) is answered by
    one rerun with the capacity its error recommends: ``(main, note)``."""
    import contextlib
    import io
    import re
    import yaml
    from enflow_tpu_torch.train.driver import Main

    main = Main(device="cuda")
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            main.setup(str(path))
        return main, ""
    except ValueError as e:
        rec = re.search(r"Recommended dynamics\.nbr_capacity >= (\d+)",
                        str(e))
        if rec is None:
            raise
        cfg = yaml.safe_load(Path(path).read_text())
        cfg["dynamics"]["nbr_capacity"] = int(rec.group(1))
        again = Path("generate_recommended.yaml")
        again.write_text(yaml.safe_dump(cfg))
        reset_counts()
        main = Main(device="cuda")
        with contextlib.redirect_stdout(io.StringIO()):
            main.setup(str(again))
        return main, (f" (the capacity check refused auto: {e}; rerun with "
                      f"the recommended nbr_capacity {rec.group(1)})")


def neighbor_sets(cfg, sys):
    """Each atom's valid neighbor indices in ``cfg``'s neighbor mode,
    sorted (``N`` for an empty slot), and the share of valid slots."""
    import torch
    from enflow_tpu_torch.data.neighbors import neighbors_with_diffs
    nbrs, _ = neighbors_with_diffs(sys.pos, sys.box, sys.mask, sys.r_cut,
                                   cfg.nbr_capacity, cfg.nbr_mode,
                                   cfg.cells_per_dim, cfg.cell_capacity)
    n = sys.pos.shape[1]
    idx = torch.where(nbrs.mask, nbrs.idx.long(), n)
    return idx.sort(dim=-1).values, float(nbrs.mask.float().mean())


def generate_phase(card, tmp):
    """``example/generate.yaml`` as committed through the port's driver in
    the working directory ``tmp``, from the checkpoint phase train wrote
    there: the MD of 2,944 atoms (K7 r), ``nbr_capacity: auto``, the
    capacity check, the flow's reverse, forward and reverse (K5 at A =
    2,944), ``h.out``, ``test_out.xyz``, the log and the trajectory; then
    the first frame reversed again in ``cell`` mode (auto cells)."""
    import contextlib
    import dataclasses
    import io
    import os
    import numpy as np
    import torch
    import yaml
    from enflow_tpu_torch.flow import reverse
    from enflow_tpu_torch.ops import edge_pipeline as ep
    from enflow_tpu_torch.ops import pair_energy as pe

    src = ROOT / "example" / "generate.yaml"
    sec = yaml.safe_load(src.read_text())["dataset"]
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        reset_counts()
        with timed_md() as md:
            main, note = generate_setup(src)
        md_launches = (pe.counts.r_launches, pe.counts.r2_launches,
                       plain_calls())
        require(md_launches == (GEN_MD_LAUNCHES, 0, 0),
                f"generate MD launches (K7 r, r2, plain) {md_launches} != "
                f"({GEN_MD_LAUNCHES}, 0, 0)")
        cfg, n_iter = main.flow_cfg, main.flow_cfg.n_iter
        A, nf = int(sec["n_atoms"]), main.node_nf
        require(len(main.dataset) == GEN_FRAMES,
                f"{len(main.dataset)} frames, expected {GEN_FRAMES}")
        require(cfg.nbr_mode == "dense" and cfg.nbr_capacity < A,
                f"generate runs {cfg.nbr_mode} with capacity "
                f"{cfg.nbr_capacity}, not the top-k format")

        reset_counts()
        printed = io.StringIO()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            out = main.generate()
        torch.cuda.synchronize()
        flow_s = time.perf_counter() - t0
        k5, k6 = ep.counts.fwd_launches, ep.counts.bwd_launches
        lines = printed.getvalue().split()
        require(lines == ["True", "True"],
                f"round trip reverse(forward(out)) == out printed {lines}")
        require((k5, k6) == (3 * n_iter, 0),
                f"generate K5/K6 launches {(k5, k6)} != ({3 * n_iter}, 0)")
        require(plain_calls() == 0, "a plain version ran in generate")
        h = np.loadtxt("h.out", ndmin=2)
        require(h.shape == (A, nf) and set(np.unique(h)) <= {0.0, 1.0}
                and (h.sum(1) == 1).all(),
                f"h.out of shape {h.shape}, not one-hot [{A}, {nf}]")
        xyz = Path("test_out.xyz").read_text().splitlines()
        require(int(xyz[0]) == A and len(xyz) == A + 2,
                f"test_out.xyz holds {len(xyz) - 2} atoms, expected {A}")
        log = Path(sec["log"]).read_text().splitlines()
        traj = Path(sec["traj"]).read_text()
        require(len(log) == GEN_FRAMES + 1,
                f"{len(log) - 1} log rows, expected {GEN_FRAMES}")
        # the thermostat's mean temperature over the log's second half
        # against the dataset's (the checkpoint's) within 20%
        temps = [float(row.split(",")[2]) for row in log[1:]]
        t_mean = statistics.mean(temps[GEN_FRAMES // 2:])
        t_want = float(main.args["dataset"]["temp"])
        require(abs(t_mean / t_want - 1.0) < 0.2,
                f"MD mean temperature {t_mean:.2f} K, the thermostat's "
                f"{t_want:.2f} K")
        require(traj.count("MODEL ") == GEN_FRAMES
                and traj.count("\nATOM  ") == GEN_FRAMES * A,
                f"{traj.count('MODEL ')} trajectory models, expected "
                f"{GEN_FRAMES}")

        # cell mode on the first frame: the neighbour sets of the top-k
        # build, and the reverse within the edge kernels' f32 tolerance
        batch = next(iter(main.train_loader))
        cell_cfg = dataclasses.replace(
            cfg, nbr_mode="cell", **main._cell_params({"nbr_mode": "cell"}))
        topk_sets, valid = neighbor_sets(cfg, batch)
        cell_sets, _ = neighbor_sets(cell_cfg, batch)
        same_sets = torch.equal(topk_sets, cell_sets)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            cell_out = reverse(main.params, cell_cfg, batch)
        torch.cuda.synchronize()
        cell_s = time.perf_counter() - t0
        k5_cell = ep.counts.fwd_launches
        dpos = float((cell_out.pos - out.pos).abs().max())
        same_h = torch.equal(cell_out.h, out.h)
        tol = TOL_EDGE["float32"]
        require(same_sets, "cell-mode neighbour sets differ from top-k's")
        require(k5_cell == n_iter and plain_calls() == 0,
                f"the cell-mode reverse made {k5_cell} K5 launches")
        require(dpos <= tol and same_h,
                f"cell-mode reverse differs from top-k's: max |dpos| "
                f"{dpos:.3e} (tol {tol:g}), h equal {same_h}")
    finally:
        os.chdir(cwd)
    phase("generate", f"generate.yaml on {card}: {A} atoms, auto capacity "
          f"{cfg.nbr_capacity}{note}; MD {md.seconds[0]:.4f} s "
          f"({md_launches[0]} K7 r launches, {GEN_FRAMES} frames; with "
          f"the frames' copy, the log and the traj "
          f"{md.process_seconds[0]:.4f} s); flow "
          f"{flow_s:.4f} s (reverse, forward, reverse: {k5} K5 launches, "
          f"0 plain calls); round trip True True; h.out {list(h.shape)} "
          f"one-hot; test_out.xyz {A} atoms; log {len(log) - 1} rows "
          f"(mean temperature of the second half {t_mean:.2f} K, the "
          f"thermostat's {t_want:.2f} K), traj {GEN_FRAMES} models; "
          f"{valid:.3f} of the slots valid")
    phase("generate", f"cell mode (cells_per_dim {cell_cfg.cells_per_dim}, "
          f"cell_capacity {cell_cfg.cell_capacity}) on the first frame: "
          f"neighbour sets equal top-k's: {same_sets}; reverse {cell_s:.4f}"
          f" s ({k5_cell} K5 launches), max |pos - top-k pos| {dpos:.3e} "
          f"(tol {tol:g}), h equal: {same_h}")
    return dict(capacity=cfg.nbr_capacity, C=2 * nf + 1,
                H=main.hidden_nf, A=A, valid=valid, k5=k5,
                k7_r=md_launches[0], md_s=md.seconds[0],
                process_s=md.process_seconds[0], flow_s=flow_s,
                nf=nf, temp=main.args["dataset"]["temp"],
                softening=main.softening)


def dataset_phase(card, tmp, gen):
    """``mode: dataset`` on generate.yaml's dataset section with n_iter
    cut to DATASET_STEPS and the facts generate injects from the checkpoint
    (node_nf, temp, softening) written in, plus a processed_file, a log and
    a traj: the MD on the card writes all three; a second run reads the
    cache back and simulates nothing."""
    import contextlib
    import io
    import os
    import numpy as np
    import yaml
    from enflow_tpu_torch.ops import pair_energy as pe
    from enflow_tpu_torch.train.driver import Main

    cfg = yaml.safe_load((ROOT / "example" / "generate.yaml").read_text())
    cfg["mode"] = "dataset"
    sec = cfg["dataset"]
    sec.update(n_iter=DATASET_STEPS, node_nf=gen["nf"], temp=gen["temp"],
               softening=gen["softening"],
               processed_file="data/lj_dataset/processed.pkl",
               log="data/lj_dataset/log.txt", traj="data/lj_dataset/traj.pdb")
    frames = DATASET_STEPS // int(sec["interval"])
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        Path("dataset.yaml").write_text(yaml.safe_dump(cfg))
        reset_counts()
        with timed_md() as md, contextlib.redirect_stdout(io.StringIO()):
            ds = Main(device="cuda")("dataset.yaml")
        launches = pe.counts.r_launches
        want = 200 + DATASET_STEPS + frames
        require(launches == want and plain_calls() == 0,
                f"dataset MD launches {launches} != {want}")
        log = Path(sec["log"]).read_text().splitlines()
        traj = Path(sec["traj"]).read_text()
        cache = Path("data/lj_dataset/processed.torch.npz")
        require(len(ds) == frames and len(log) == frames + 1
                and traj.count("MODEL ") == frames and cache.exists(),
                f"dataset: {len(ds)} frames, {len(log) - 1} log rows, "
                f"{traj.count('MODEL ')} models, cache {cache.exists()}")
        reset_counts()
        again = Main(device="cuda")("dataset.yaml")
        same = all(np.array_equal(a.pos, b.pos) and np.array_equal(a.h, b.h)
                   for a, b in zip(again.samples, ds.samples))
        require(pe.counts.r_launches == 0 and same and len(again) == frames,
                "the second dataset run did not read the cache back")
    finally:
        os.chdir(cwd)
    phase("dataset", f"mode dataset on {card} (generate.yaml's dataset, "
          f"n_iter {DATASET_STEPS}, node_nf/temp/softening of the "
          f"checkpoint): MD {md.seconds[0]:.4f} s ({launches} K7 r "
          f"launches; with the frames' copy, the log and the traj "
          f"{md.process_seconds[0]:.4f} s), {frames} frames; "
          f"processed_file, log ({frames} rows)"
          f" and traj ({frames} models) written; a second run read the "
          f"cache (0 launches, the same samples)")


# The VI phase's cuts of example/vi_lj13.yaml (100 epochs x 100 steps):
# epochs and steps per epoch only, every width and option as committed
VI_EPOCHS, VI_STEPS = 3, 10


def vi_driver(tmp, num_epochs, stl=False, config="vi_lj13.yaml",
              steps=VI_STEPS):
    """The port's driver set up from ``example/<config>`` with
    ``num_epochs`` and ``steps_per_epoch`` cut (and ``stl`` switched on
    when asked), run from the working directory ``tmp`` (where the
    checkpoint and the metrics CSV go)."""
    import os
    import yaml
    from enflow_tpu_torch.train.driver import Main

    cfg = yaml.safe_load((ROOT / "example" / config).read_text())
    cfg["training"].update(num_epochs=num_epochs, steps_per_epoch=steps)
    if stl:
        cfg["training"]["stl"] = True
    path = Path(tmp) / config
    path.write_text(yaml.safe_dump(cfg))
    os.chdir(tmp)
    main = Main(device="cuda")
    main.setup(str(path))
    return main


def time_vi_steps(main):
    """Wrap ``main.vi_step`` so that each step appends its host-clock
    seconds (the card synchronized before, the loss read after) and its
    loss to the two lists returned."""
    import torch
    step_s, losses = [], []
    inner = main.vi_step

    def timed(gen, target):
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss, bad = inner(gen, target)
        losses.append(float(loss))          # synchronizes
        step_s.append(time.perf_counter() - t)
        return loss, bad
    main.vi_step = timed
    return step_s, losses


def vi_launches():
    from enflow_tpu_torch.ops import egcl_allpairs as ea
    c = ea.counts
    # the paths of these counts stay on the one-molecule kernels
    blocks, _ = blocks_launches()
    require(not any(blocks.values()), f"block-pair launches {blocks} on a "
            "path within the one-molecule kernels' limits")
    return dict(k1=c.fwd_launches, k2=c.bwd_launches + c.bwd_f32_launches,
                k2_params=c.bwd_param_launches, plain=plain_calls())


def vi_phase(card, keep_dir):
    """The flow-VI path: ``example/vi_lj13.yaml`` through the port's driver
    (VI_EPOCHS x VI_STEPS), a 1-epoch resume, one ``stl: true`` epoch, then
    ``example/sample_lj13.yaml`` from the checkpoint they wrote; the
    checkpoint is copied to ``keep_dir`` for the mcmc, remc and ti
    phases."""
    import os
    import shutil
    import torch
    from enflow_tpu_torch.train.driver import Main

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        try:
            main = vi_driver(tmp, VI_EPOCHS)
            n_iter, P = main.n_iter, main.vi_particles
            step_s, losses = time_vi_steps(main)
            reset_counts()
            main.train()
            torch.cuda.synchronize()
            n_steps = VI_EPOCHS * VI_STEPS
            got = vi_launches()
            # per step: the reverse flow's n_iter EGCLs forward (K1) and
            # backward with parameter gradients (K2); nothing else
            want = dict(k1=n_iter * n_steps, k2=0, k2_params=n_iter * n_steps,
                        plain=0)
            require(len(step_s) == n_steps, f"{len(step_s)} VI steps")
            require(got == want, f"VI launches {got} != {want}")
            require(all(math.isfinite(x) for x in losses),
                    f"non-finite VI losses {losses}")
            require(Path("lj13_vi.cpt").exists(), "no VI checkpoint written")

            again = vi_driver(tmp, 1)
            require(again.start_epoch == VI_EPOCHS,
                    f"the VI rerun resumed at epoch {again.start_epoch}")
            reset_counts()
            again.train()
            torch.cuda.synchronize()
            want1 = dict(k1=n_iter * VI_STEPS, k2=0,
                         k2_params=n_iter * VI_STEPS, plain=0)
            require(vi_launches() == want1,
                    f"resumed VI epoch launches {vi_launches()} != {want1}")

            stl = vi_driver(tmp, 1, stl=True)
            require(stl.start_epoch == VI_EPOCHS + 1,
                    f"the STL run resumed at epoch {stl.start_epoch}")
            reset_counts()
            stl.train()
            torch.cuda.synchronize()
            # STL re-encodes through the forward flow with detached
            # parameters: n_iter more K1 and n_iter input-gradient K2
            want_stl = dict(k1=2 * n_iter * VI_STEPS, k2=n_iter * VI_STEPS,
                            k2_params=n_iter * VI_STEPS, plain=0)
            require(vi_launches() == want_stl,
                    f"STL epoch launches {vi_launches()} != {want_stl}")
            with open("lj13_vi_metrics.csv") as f:
                rows = [r.split(",") for r in f.read().strip().splitlines()]
            require(rows[0][:3] == ["time", "epoch", "loss"]
                    and [int(r[1]) for r in rows[1:]]
                    == list(range(VI_EPOCHS + 2))
                    and all(math.isfinite(float(r[2])) for r in rows[1:]),
                    f"metrics CSV rows {rows}")

            # sampling from the VI checkpoint, as committed
            sample_cfg = Path(tmp) / "sample_lj13.yaml"
            sample_cfg.write_text(
                (ROOT / "example" / "sample_lj13.yaml").read_text())
            sampler = Main(device="cuda")
            sampler.setup(str(sample_cfg))
            reset_counts()
            res = sampler.sample()
            torch.cuda.synchronize()
            # n_temps 10, 1 sweep of 5 leapfrog steps: 51 value-and-grads
            n_vg = 1 + 10 * 1 * 5
            want_smc = dict(k1=n_iter + n_vg * n_iter, k2=n_vg * n_iter,
                            k2_params=0, plain=0)
            require(vi_launches() == want_smc,
                    f"sample_lj13 launches {vi_launches()} != {want_smc}")
            require(float(res.beta_history[-1]) > 1.0 - 1e-5,
                    "sample_lj13 did not reach beta = 1")
            require(math.isfinite(float(res.log_Z)), "log_Z not finite")
            require(Path("lj13_samples.npz").exists(), "no samples written")
            shutil.copy("lj13_vi.cpt", keep_dir)
        finally:
            os.chdir(cwd)
    later = step_s[VI_STEPS:]
    s_step = statistics.median(later)
    curve = [statistics.fmean(losses[i:i + VI_STEPS])
             for i in range(0, len(losses), VI_STEPS)]
    phase("vi", f"vi_lj13.yaml on {card}: {VI_EPOCHS} epochs x {VI_STEPS} "
          f"steps of {P} particles (cut from 100 x 100), {s_step:.5f} s/step "
          f"(median of epochs 1-{VI_EPOCHS - 1}; first step "
          f"{step_s[0]:.4f} s), {P / s_step:.1f} particles/s; epoch losses "
          + ", ".join(f"{x:.2f}" for x in curve)
          + f"; launches per run K1 {got['k1']} K2 with parameter gradients "
          f"{got['k2_params']}, plain calls {got['plain']}; resumed at epoch {VI_EPOCHS}, "
          f"an STL epoch with {want_stl['k1']} K1 + {want_stl['k2']} "
          f"input-gradient K2 + {want_stl['k2_params']} parameter-gradient "
          f"K2; sample_lj13.yaml from the checkpoint: "
          f"{res.particles['pos'].shape[0]} particles, log_Z "
          f"{float(res.log_Z):.4f}, beta 1")
    return dict(s_step=s_step, k2_params=got["k2_params"], curve=curve)


# The vi55 phase's cut of example/vi_lj55.yaml (40 epochs x 100 steps):
# one epoch of VI55_STEPS steps, every width and option as committed
VI55_STEPS = 5
# phase sharded: the density check on SHARDED_CHECK_P particles, f32,
# within TOL_SHARDED of each output's largest magnitude (ring blocks
# against the all-pairs kernels' tiles: f32 sums in another order through
# 5 flow steps); sample_fluid.yaml's scaled run at FLUID_N atoms
SHARDED_CHECK_P = 64
TOL_SHARDED = 1e-3
SHARDED_EPOCHS = 2
FLUID_N = 1024


def vi55_phase(card, keep_dir):
    """``example/vi_lj55.yaml`` (LJ55, 256 particles, H=128, bf16)
    through the port's driver for one epoch of VI55_STEPS steps in the
    directory ``keep_dir`` (whose checkpoint phase sharded reads): 5 K1 +
    5 parameter-gradient K2 launches per step at N=55, no plain call,
    finite losses, a checkpoint and a metrics CSV; then K1 and K2 p at
    that shape (B=256, N=55) against the plain version and timed."""
    import os
    import torch
    from enflow_tpu_torch.ops import egcl_allpairs as ops

    cwd = os.getcwd()
    try:
        main = vi_driver(keep_dir, 1, config="vi_lj55.yaml",
                         steps=VI55_STEPS)
        n_iter, P = main.n_iter, main.vi_particles
        step_s, losses = time_vi_steps(main)
        reset_counts()
        main.train()
        torch.cuda.synchronize()
        got = vi_launches()
        want = dict(k1=n_iter * VI55_STEPS, k2=0,
                    k2_params=n_iter * VI55_STEPS, plain=0)
        require(len(step_s) == VI55_STEPS, f"{len(step_s)} VI55 steps")
        require(got == want, f"vi_lj55 launches {got} != {want}")
        require(all(math.isfinite(x) for x in losses),
                f"non-finite vi_lj55 losses {losses}")
        require(Path("lj55_vi.cpt").exists(), "no LJ55 checkpoint")
        with open("lj55_vi_metrics.csv") as f:
            rows = [r.split(",") for r in f.read().strip().splitlines()]
        require(rows[0][:3] == ["time", "epoch", "loss"]
                and len(rows) == 2 and math.isfinite(float(rows[1][2])),
                f"vi_lj55 metrics CSV rows {rows}")
    finally:
        os.chdir(cwd)
    s_step = statistics.median(step_s[1:])
    # K1 and K2 p at this path's shape: 47 tiles a molecule (the last one
    # partial), one warpgroup per SM walking about two molecules, whose
    # tiles add into the same slice of partials
    shape = dict(B=P, N=55, nf=5, H=128)
    h, pos, box, mask_f, W, dagg, dfsum, mask = edge_inputs(
        shape, torch.bfloat16, seed=23)
    args = (h, pos, box, mask_f, W, dagg, dfsum)
    fwd = lambda: ops.allpairs_edges_fwd(h, pos, box, mask_f, W)
    pbwd = lambda: ops.allpairs_edges_bwd(*args, params=True)
    names = ("agg", "f_sum") + PARAM_OUT
    errs = rel_errs(names, fwd() + pbwd(), ops.allpairs_edges_plain(
        h, pos, box, mask_f, W) + ops.allpairs_edges_plain_bwd(*args,
                                                               params=True))
    tol = {n: (TOL_PARAM if n in PARAM_OUT[2:] else TOL)["bfloat16"]
           for n in names}
    ok = all(rel <= tol[n] for n, (_, rel) in errs.items())
    phase("vi55", f"B={P} N=55 H=128 bf16 K1 and K2 p vs plain max_abs/rel "
          "err: " + "  ".join(f"{n} {a:.2e}/{r:.1e}"
                              for n, (a, r) in errs.items())
          + f"  tol agg/f_sum/dh/dpos {TOL['bfloat16']:g}, parameters "
          f"{TOL_PARAM['bfloat16']:g} -> {'ok' if ok else 'FAIL'}")
    require(ok, "K1 or K2 p disagrees with plain at vi_lj55.yaml's shape")
    t_f, t_p = cuda_time_ms(fwd), cuda_time_ms(pbwd)
    t_pl_f = cuda_time_ms(lambda: ops.allpairs_edges_plain(
        h, pos, box, mask_f, W), reps=10, calls=2)
    t_pl_p = cuda_time_ms(lambda: ops.allpairs_edges_plain_bwd(
        *args, params=True), reps=10, calls=2)
    fl_f, _, by_f, _ = work(shape, "bfloat16", mask)
    fl_p, by_p = work_params(shape, "bfloat16", mask)
    b_f = bound(fl_f, by_f, PEAK_FLOPS["bfloat16"])
    b_p = bound(fl_p, by_p, PEAK_FLOPS["bfloat16"])
    floors = sfu_alu_floor(shape, mask)
    phase("vi55", f"B={P} N=55 H=128 bf16 time ms: K1 {t_f:.4f} (plain "
          f"{t_pl_f:.4f}, bound {b_f[0]:.4f}, {b_f[1]}; MUFU / elementwise "
          f"floors {floors['fwd'][0]:.4f} / {floors['fwd'][1]:.4f}) | K2 p "
          f"{t_p:.4f} (plain {t_pl_p:.4f}, bound {b_p[0]:.4f}, {b_p[1]}; "
          f"floors {floors['bwd_params'][0]:.4f} / "
          f"{floors['bwd_params'][1]:.4f})")
    phase("vi55", f"vi_lj55.yaml on {card}: 1 epoch x {VI55_STEPS} steps of "
          f"{P} particles at N=55 (cut from 40 x 100), {s_step:.5f} s/step "
          f"(median of steps 2-{VI55_STEPS}; first {step_s[0]:.4f} s), "
          f"{P / s_step:.1f} particles/s; losses "
          + ", ".join(f"{x:.2f}" for x in losses)
          + f"; launches K1 {got['k1']} K2 with parameter gradients "
          f"{got['k2_params']}, plain calls 0; checkpoint and metrics CSV "
          "written")
    return s_step


def kernel_launches():
    """Every kernel launch (all-pairs, gathered-edge, pair energy, of any
    size rule) since the counts were reset."""
    from enflow_tpu_torch.ops import edge_pipeline as ep
    from enflow_tpu_torch.ops import egcl_allpairs as ea
    from enflow_tpu_torch.ops import pair_energy as pe
    return sum(v for m in (ea, ep, pe) for k, v in vars(m.counts).items()
               if k.endswith("launches"))


def ring_calls():
    from enflow_tpu_torch.parallel import ring
    return ring.counts.ring_calls


def reset_ring():
    from enflow_tpu_torch.parallel import ring
    reset_counts()
    ring.counts.reset()


def max_rel(got, want):
    """``max |got - want| / max |want|`` over tensors or dicts of them."""
    if isinstance(want, dict):
        return max(max_rel(got[k], want[k]) for k in want)
    want = want.detach().float()
    return float((got.detach().float() - want).abs().max()
                 / want.abs().max().clamp(min=1e-30))


def peak_gb():
    import torch
    return torch.cuda.max_memory_allocated() / 1e9


def sharded_sample(card, lj55_dir):
    """Phase sharded (a): ``sample_sharded.yaml`` from the LJ55 VI
    checkpoint, its densities first held against the dense padded
    oracle."""
    import dataclasses
    import numpy as np
    import torch
    from enflow_tpu_torch.sample.mcmc import batched_value_and_grad
    from enflow_tpu_torch.sample.sharded import make_sample_fns

    main = config_driver(lj55_dir, "sample_sharded.yaml", virtual_devices=4)
    require(main.mesh.shape == {"data": 1, "atom": 4},
            f"mesh {main.mesh.shape}")
    sec = main.args["sampling"]
    target, n_atoms = main._build_pos_target(sec["target"])
    box = float(sec["target"].get("box", 1e3))
    r_cut = float(sec["target"].get("r_cut", 1e2))
    # f32 message passing on both sides: the ring in plain f32, the oracle
    # on the f32 all-pairs kernels
    cfg32 = dataclasses.replace(main.flow_cfg, egcl=dataclasses.replace(
        main.flow_cfg.egcl, compute_dtype=None))
    fns = make_sample_fns(main.params, cfg32, target, n_atoms, box, r_cut,
                          mesh=main.mesh)
    n_pad = fns[3]
    dense = make_sample_fns(main.params, cfg32, target, n_atoms, box, r_cut,
                            n_pad=n_pad)
    require(n_pad == 56, f"LJ55 padded to {n_pad}")
    gen = torch.Generator(device="cuda").manual_seed(11)
    z = main._latents(gen, SHARDED_CHECK_P, n_pad)
    x = fns[0](z)
    errs = {"propose": max_rel(x, dense[0](z))}
    for name, i in (("log_q0", 1), ("log_p", 2)):
        v, g = batched_value_and_grad(fns[i])(x)
        dv, dg = batched_value_and_grad(dense[i])(x)
        errs[name], errs[f"d{name}"] = max_rel(v, dv), max_rel(g, dg)
    require(max(errs.values()) <= TOL_SHARDED and all(
        math.isfinite(e) for e in errs.values()),
        f"sharded densities against the dense oracle: {errs}")

    P, n_temps = int(sec["n_particles"]), int(sec["n_temps"])
    mcmc, n_lf = int(sec["mcmc_steps"]), int(sec["n_leapfrog"])
    n_vg = 1 + n_temps * mcmc * n_lf
    want_ring = main.n_iter * (1 + n_vg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_ring()
    res, secs = timed_sample(main)
    rings, kern, plain = ring_calls(), kernel_launches(), plain_calls()
    peak = peak_gb()
    check_smc(res, "sample_sharded", P, n_pad)
    require(all(t.is_cuda for t in res.particles.values()),
            "sample_sharded particles off the card")
    with np.load(sec["output"]) as npz:
        shape = npz["pos"].shape
    require(shape == (P, n_atoms, 3), f"npz pos {shape}")
    require(rings == want_ring and kern == 0 and plain == 0,
            f"sample_sharded: ring calls {rings} (want {want_ring}), kernel "
            f"launches {kern}, plain calls {plain}")
    phase("sharded", f"sample_sharded.yaml densities vs the dense padded "
          f"oracle on {card} (P={SHARDED_CHECK_P}, N 55 -> {n_pad}, f32) "
          f"max rel err: "
          + "  ".join(f"{k} {v:.2e}" for k, v in errs.items())
          + f"  (tol {TOL_SHARDED:g})")
    phase("sharded", f"sample_sharded.yaml as committed on {card}, 4 "
          f"virtual devices, {n_temps} temps: {P} particles x {n_atoms} "
          f"atoms (padded {n_pad}), {secs:.3f} s, {P / secs:.1f} samples/s, "
          f"log_Z {float(res.log_Z):.4f}, beta {float(res.beta_history[-1])}"
          f", ring calls {rings}, kernel launches 0, plain calls 0, peak "
          f"{peak:.2f} GB; npz pos {shape}")
    return dict(secs=secs, peak=peak, rings=rings)


def sharded_train(card, tmp):
    """Phase sharded (b): ``train_sharded.yaml``, 2 of its epochs and a
    resume, its first step held against the dense port."""
    import os
    import yaml
    import torch
    from enflow_tpu_torch.flow.integrators import forward
    from enflow_tpu_torch.flow.loss import alchemical_nll
    from enflow_tpu_torch.flow.sharded import make_sharded_nll
    from enflow_tpu_torch.ops import pair_energy as pe
    from enflow_tpu_torch.train.driver import Main

    cfg = yaml.safe_load((ROOT / "example" / "train_sharded.yaml").read_text())
    cfg["training"]["num_epochs"] = SHARDED_EPOCHS
    path = Path(tmp) / "train_sharded.yaml"
    path.write_text(yaml.safe_dump(cfg))
    os.chdir(tmp)
    reset_ring()
    t0 = time.perf_counter()
    main = Main(device="cuda", virtual_devices=4)
    main.setup(str(path))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    md_launches = pe.counts.r_launches
    require(md_launches > 0 and main.train_loader.n_max == 128,
            f"LJ-128 dataset: {md_launches} K7 r launches, n_max "
            f"{main.train_loader.n_max}")

    # the first step's loss and gradient against the dense port
    mc = main.flow_cfg
    n_lg = 3 if mc.dequantizer == "argmax" else 2
    main.train_loader.set_epoch(main.start_epoch)
    batch = next(iter(main.train_loader))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(main._noise_seed(main.start_epoch))
    eps = main._noise(gen, batch.h)
    loss_s = make_sharded_nll(main.mesh, mc, main.lj_kBT, main.softening,
                              num_log_gaussian_calls=n_lg, data_axis="data")(
        main.params, batch, eps=eps)
    g_s = torch.autograd.grad(loss_s, main._leaves, allow_unused=True)
    out, ldj = forward(main.params, mc, batch, eps=eps)
    loss_d = alchemical_nll(out, ldj, main.lj_kBT, main.softening,
                            num_log_gaussian_calls=n_lg)
    g_d = torch.autograd.grad(loss_d, main._leaves, allow_unused=True)
    require([a is None for a in g_s] == [b is None for b in g_d],
            "train_sharded: the sharded and dense NLL use other parameters")
    loss_s, loss_d = loss_s.item(), loss_d.item()
    err_l = abs(loss_s - loss_d) / abs(loss_d)
    err_g = max(max_rel(a, b) for a, b in zip(g_s, g_d) if b is not None)
    require(err_l <= TOL_SHARDED and err_g <= TOL_SHARDED,
            f"train_sharded first step vs dense: loss {err_l:.2e}, "
            f"gradient {err_g:.2e}")

    n_steps = SHARDED_EPOCHS * len(main.train_loader)
    reset_ring()
    step_s, losses = timed_train(main)
    rings, kern, plain = ring_calls(), kernel_launches(), plain_calls()
    want_ring = n_steps * main.n_iter
    require(len(step_s) == n_steps and rings == want_ring and kern == 0
            and plain == 0 and all(math.isfinite(x) for x in losses),
            f"train_sharded: {len(step_s)} steps, ring calls {rings} (want "
            f"{want_ring}), kernel launches {kern}, plain {plain}, losses "
            f"{losses}")
    cfg["training"]["num_epochs"] = 1
    path.write_text(yaml.safe_dump(cfg))
    again = Main(device="cuda", virtual_devices=4)
    again.setup(str(path))
    require(again.start_epoch == SHARDED_EPOCHS,
            f"resume at epoch {again.start_epoch}")
    r_s, r_losses = timed_train(again)
    require(all(math.isfinite(x) for x in r_losses), "resume losses")
    s_step = statistics.median(step_s[1:])
    phase("sharded", f"train_sharded.yaml first step vs the dense port on "
          f"{card} (K5/K6, K7 r2; same batch and noise, f32): loss "
          f"{loss_s:.4f} vs "
          f"{loss_d:.4f}, rel err {err_l:.2e}, gradient max rel "
          f"err {err_g:.2e} (tol {TOL_SHARDED:g})")
    phase("sharded", f"train_sharded.yaml on {card}, 4 virtual devices: "
          f"set-up {setup_s:.3f} s (LJ-128 MD, {md_launches} K7 r "
          f"launches, {len(main.dataset)} frames); {SHARDED_EPOCHS} of 10 "
          f"epochs, {n_steps} steps, {s_step:.5f} s/step (median of steps "
          f"2-{n_steps}), losses " + ", ".join(f"{x:.3f}" for x in losses)
          + f"; ring calls {rings}, kernel launches 0, plain calls 0; resume "
          f"at epoch {SHARDED_EPOCHS}: {len(r_s)} steps, "
          f"{statistics.median(r_s):.5f} s/step")
    return dict(s_step=s_step, setup_s=setup_s)


def sharded_fluid(card, tmp):
    """Phase sharded (c): ``sample_fluid.yaml`` as far as memory allows."""
    import os
    import yaml
    import torch
    from enflow_tpu_torch.sample import smc
    from enflow_tpu_torch.sample.mcmc import batched_value_and_grad
    from enflow_tpu_torch.sample.sharded import make_sample_fns
    from enflow_tpu_torch.train.driver import Main

    cfg = yaml.safe_load((ROOT / "example" / "sample_fluid.yaml").read_text())
    path = Path(tmp) / "sample_fluid.yaml"
    path.write_text(yaml.safe_dump(cfg))
    os.chdir(tmp)
    main = Main(device="cuda", virtual_devices=4)
    main.setup(str(path))
    tsec = dict(main.args["sampling"]["target"])
    gen = torch.Generator(device="cuda").manual_seed(17)

    def fns(n_atoms):
        sec = dict(tsec, n_atoms=n_atoms,
                   box=float(tsec["box"]) * (n_atoms / tsec["n_atoms"])
                   ** (1 / 3))
        target, _ = main._build_pos_target(sec)
        return make_sample_fns(main.params, main.flow_cfg, target, n_atoms,
                               sec["box"], float(sec.get("r_cut", 1e2)),
                               mesh=main.mesh), sec["box"]

    def value_and_grad(f, x):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated() / 1e9
        v, _ = batched_value_and_grad(f)(x)
        torch.cuda.synchronize()
        return v, peak_gb() - base

    def anneal(q0, lp, prop, n_pad, label):
        """A value-and-grad on one particle, then the short SMC on as many
        particles as fit; returns the phase line's text."""
        x = prop(main._latents(gen, 1, n_pad))
        _, one_gb = value_and_grad(q0, x)
        torch.cuda.empty_cache()
        free = torch.cuda.mem_get_info()[0] / 1e9
        P = max(1, min(8, int(0.8 * free / one_gb)))
        x = prop(main._latents(gen, P, n_pad))
        reset_ring()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = smc(gen, x, log_q0=q0, log_p=lp, n_temps=2, mcmc_steps=1,
                  step_size=0.01, n_leapfrog=2)
        torch.cuda.synchronize()
        smc_s, smc_gb = time.perf_counter() - t0, peak_gb()
        require(math.isfinite(float(res.log_Z)) and kernel_launches() == 0,
                f"{label} SMC: log_Z {float(res.log_Z)}, kernel launches "
                f"{kernel_launches()}")
        del x, res
        torch.cuda.empty_cache()
        return (f"a value-and-grad of log_q0 {one_gb:.2f} GB a particle; "
                f"SMC (2 fixed temps, 1 x 2 HMC) on {P} particles "
                f"{smc_s:.3f} s, peak {smc_gb:.2f} GB, ring calls "
                f"{ring_calls()}"), one_gb

    n_full = int(tsec["n_atoms"])
    (prop, q0, lp, n_pad), _ = fns(n_full)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with torch.no_grad():
        x = prop(main._latents(gen, 2, n_pad))
        vq, vp = q0(x), lp(x)
    torch.cuda.synchronize()
    nograd_s, nograd_gb = time.perf_counter() - t0, peak_gb()
    require(bool(torch.isfinite(vq).all() and torch.isfinite(vp).all()),
            "sample_fluid densities not finite")
    del x
    full, full_gb = anneal(q0, lp, prop, n_pad, "sample_fluid")
    (prop, q0, lp, n_pad), box = fns(FLUID_N)
    scaled, one_gb = anneal(q0, lp, prop, n_pad, "scaled sample_fluid")
    phase("sharded", f"sample_fluid.yaml on {card}, 4 virtual devices "
          f"(2,944 atoms, 736-atom blocks, H=64, bf16, drift, a fresh "
          f"flow): propose + log_q0 + log_p without a gradient on 2 "
          f"particles {nograd_s:.3f} s, peak {nograd_gb:.2f} GB; {full}")
    phase("sharded", f"sample_fluid.yaml on {card} scaled to {FLUID_N} "
          f"atoms (box {box:.3f}, rho* kept): {scaled}")
    return dict(full_gb=full_gb, one_gb=one_gb, nograd_gb=nograd_gb)


def sharded_phase(card, lj55_dir):
    """Phase sharded (the module docstring's 9b)."""
    import contextlib
    import io
    import os
    import torch
    from enflow_tpu_torch.parallel.dryrun import dryrun_multichip

    cwd = os.getcwd()
    try:
        smp = sharded_sample(card, lj55_dir)
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory() as tmp:
            trn = sharded_train(card, tmp)
            os.chdir(cwd)
            torch.cuda.empty_cache()
            fl = sharded_fluid(card, tmp)
    finally:
        os.chdir(cwd)
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        dryrun_multichip(4)
    torch.cuda.synchronize()
    lines = [ln[9:] for ln in buf.getvalue().splitlines()
             if ln.startswith("[dryrun] ")]
    require(len(lines) == 10, f"dryrun printed {lines}")
    phase("sharded", f"dryrun_multichip(4) on {card} in "
          f"{time.perf_counter() - t0:.2f} s: " + " | ".join(lines))
    return dict(sample=smp, train=trn, fluid=fl)


def config_driver(tmp, config, over=None, dynamics=None, virtual_devices=1,
                  target=None):
    """The port's driver set up from ``example/<config>`` with the keys of
    ``over`` changed in its ``sampling`` (or ``training``) section, those
    of ``target`` in that section's ``target`` and those of ``dynamics``
    in its ``dynamics`` section, run from the working directory ``tmp``
    (where its outputs go) on ``virtual_devices``."""
    import os
    import yaml
    from enflow_tpu_torch.train.driver import Main

    cfg = yaml.safe_load((ROOT / "example" / config).read_text())
    sec = cfg["sampling" if "sampling" in cfg else "training"]
    sec.update(over or {})
    if target:
        sec["target"].update(target)
    cfg["dynamics"].update(dynamics or {})
    path = Path(tmp) / config
    path.write_text(yaml.safe_dump(cfg))
    # a config's paths are relative to the repository's root
    # (vi_ala2.yaml's params_file: example/ala2_ff.yaml)
    if not (Path(tmp) / "example").exists():
        (Path(tmp) / "example").symlink_to(ROOT / "example")
    os.chdir(tmp)
    main = Main(device="cuda", virtual_devices=virtual_devices)
    main.setup(str(path))
    return main


def timed_sample(main):
    """(result, seconds) of one ``main.sample()`` between synchronizes."""
    import torch
    torch.cuda.synchronize()
    t = time.perf_counter()
    res = main.sample()
    torch.cuda.synchronize()
    return res, time.perf_counter() - t


def check_smc(res, label, P, N):
    import torch
    require(float(res.beta_history[-1]) > 1.0 - 1e-5,
            f"{label}: the anneal did not reach beta = 1")
    require(math.isfinite(float(res.log_Z)), f"{label}: log_Z not finite")
    pos = res.particles["pos"]
    require(tuple(pos.shape) == (P, N, 3) and bool(torch.isfinite(pos).all()),
            f"{label}: particles not finite or of the wrong shape")


def vi_epoch(main, label, n_steps, want):
    """One VI epoch of ``main`` with its launches held to ``want``; returns
    (seconds per step, losses)."""
    import torch
    step_s, losses = time_vi_steps(main)
    reset_counts()
    main.train()
    torch.cuda.synchronize()
    got = vi_launches()
    require(len(step_s) == n_steps, f"{label}: {len(step_s)} VI steps")
    require(got == want, f"{label} launches {got} != {want}")
    require(all(math.isfinite(x) for x in losses),
            f"{label}: non-finite VI losses {losses}")
    return step_s, losses


def kernel_key(dname, H, kind):
    """A substring of the name of the kernel that a launch of ``kind`` at
    this dtype and width runs (the wrapper's size rule), for
    ``device_ms``."""
    from enflow_tpu_torch.ops import egcl_allpairs as ops
    route = ops.kernel_for(1 if dname == "bfloat16" else 0, H, kind)
    direction = "fwd" if kind == "fwd" else "bwd"
    if route == "f32":
        return {"fwd": "egcl_f32_fwd", "bwd": "egcl_f32_bwd_kernel",
                "bwd_params": "egcl_f32_bwd_params"}[kind]
    return f"egcl_{'sm90_' if route == 'sm90' else ''}{direction}_kernel"


def allpairs_vs_plain(name, label, shape, dname, seed, kinds, time_it=True,
                      plain_reps=(20, 5), repeat=False, device=False):
    """K1 (``"fwd"``), the input-gradient K2 (``"bwd"``) and K2 p
    (``"bwd_params"``), as ``kinds`` asks, against their plain version at
    ``shape``; with ``repeat``, a second launch must give the same bits;
    with ``time_it``, each timed beside its plain version with its bound,
    and with ``device`` also as device time per launch. Returns {kind:
    (max abs err, ms, plain ms, bound, device ms)}."""
    import torch
    from enflow_tpu_torch.ops import egcl_allpairs as ops

    dtype = getattr(torch, dname)
    h, pos, box, mask_f, W, dagg, dfsum, mask = edge_inputs(shape, dtype,
                                                            seed)
    args = (h, pos, box, mask_f, W, dagg, dfsum)
    calls = {"fwd": (lambda: ops.allpairs_edges_fwd(h, pos, box, mask_f, W),
                     lambda: ops.allpairs_edges_plain(h, pos, box, mask_f,
                                                      W), ("agg", "f_sum")),
             "bwd": (lambda: ops.allpairs_edges_bwd(*args),
                     lambda: ops.allpairs_edges_plain_bwd(*args),
                     ("dh", "dpos")),
             "bwd_params": (lambda: ops.allpairs_edges_bwd(*args,
                                                           params=True),
                            lambda: ops.allpairs_edges_plain_bwd(
                                *args, params=True), PARAM_OUT)}
    fl_f, fl_b, by_f, by_b = work(shape, dname, mask)
    work_of = {"fwd": (fl_f, by_f), "bwd": (fl_b, by_b),
               "bwd_params": work_params(shape, dname, mask)}
    out, bad = {}, []
    for kind in kinds:
        kern, plain, names = calls[kind]
        ops.counts.reset()
        got = kern()
        c = ops.counts
        launched = {"fwd": c.fwd_launches, "bwd": (
            c.bwd_f32_launches if kernel_key(dname, shape["H"], kind)
            == "egcl_f32_bwd_kernel" else c.bwd_launches),
                    "bwd_params": c.bwd_param_launches}[kind]
        errs = rel_errs(names, got, plain())
        torch.cuda.synchronize()
        tol = {n: (TOL_PARAM if n in PARAM_OUT[2:] else TOL)[dname]
               for n in names}
        ok = launched == 1 and all(r <= tol[n] for n, (_, r) in errs.items())
        t = ""
        if repeat:
            same = all(bool(torch.equal(a, b)) for a, b in zip(got, kern()))
            ok = ok and same
            t = f"; a second launch gives the same bits: {same}"
        ms = plain_ms = b = dev = None
        if time_it:
            ms = cuda_time_ms(kern)
            plain_ms = cuda_time_ms(plain, reps=plain_reps[0],
                                    calls=plain_reps[1])
            b = bound(*work_of[kind], PEAK_FLOPS[dname])
            if device:
                dev = device_ms(kern, kernel_key(dname, shape["H"], kind))
            t += (f"; time ms {ms:.4f}"
                  + (f" (device {dev:.4f})" if device else "")
                  + f" plain {plain_ms:.4f}, bound {b[0]:.4f} ({b[1]}, "
                  f"{work_of[kind][0] / 1e9:.2f} GFLOP)")
        phase(name, f"{label} {kind} {dname} B={shape['B']} N={shape['N']} "
              f"nf={shape['nf']} H={shape['H']}: launches {launched}; "
              "max_abs/rel err " + "  ".join(
                  f"{n} {a:.2e}/{r:.1e}" for n, (a, r) in errs.items())
              + f"{t} -> {'ok' if ok else 'FAIL'}")
        if not ok:
            bad.append(kind)
        out[kind] = (max(a for a, _ in errs.values()), ms, plain_ms, b, dev)
    require(not bad, f"{name}: {bad} disagree with plain at {label}")
    return out


def lj55_phase(card):
    """The LJ55 pipeline. (a) ``example/sample_lj55.yaml`` as committed
    (1024 particles, 16 temperatures in segments of 8, a stage checkpoint
    every 8, a fresh shift flow, bf16): K1 and the input-gradient K2 at
    B=1024, N=55. (b) ``example/vi_lj55_coupled.yaml`` cut to 1 epoch x
    LJ55C_STEPS steps: a kick and a drift EGCL per flow step. (c) From
    (b)'s checkpoint, ``sample_lj55.yaml`` with ``position_update:
    coupled`` at 4 temperatures, chunked (2 a segment, a stage checkpoint
    every 2) and monolithic: the two must agree bit for bit. Then K1 and
    K2 at B=1024, N=55 timed beside their plain version (K2 at B=64, N=55
    is held against it in phase kernel, shape large)."""
    import os
    import torch
    from enflow_tpu_torch.sample.smc import ess_from_log_weights

    cwd = os.getcwd()
    n_iter = 5
    with tempfile.TemporaryDirectory() as tmp:
        try:
            main = config_driver(tmp, "sample_lj55.yaml")
            sec = main.args["sampling"]
            P, n_temps = sec["n_particles"], sec["n_temps"]
            reset_counts()
            res_a, secs_a = timed_sample(main)
            got_a = vi_launches()
            # value-and-grads: 1 for the caches + n_temps x sweeps x LF
            n_vg = 1 + n_temps * sec["mcmc_steps"] * sec["n_leapfrog"]
            want_a = dict(k1=n_iter + n_vg * n_iter, k2=n_vg * n_iter,
                          k2_params=0, plain=0)
            require(got_a == want_a, f"sample_lj55 launches {got_a} != "
                    f"{want_a}")
            check_smc(res_a, "sample_lj55", P, 55)
            require(Path("lj55_samples.npz").exists()
                    and not Path("lj55_samples.npz.state.npz").exists(),
                    "sample_lj55: no samples, or a stage state left over")
            ess_a = float(ess_from_log_weights(res_a.log_weights))
            phase("lj55", f"(a) sample_lj55.yaml on {card}: {P} particles x "
                  f"{n_temps} temps in segments of {sec['chunk_temps']}, a "
                  f"stage checkpoint every {sec['checkpoint_every']}: "
                  f"{secs_a:.3f} s, {P / secs_a:.1f} samples/s, log_Z "
                  f"{float(res_a.log_Z):.4f}, final ESS {ess_a:.1f}; "
                  f"launches K1 {got_a['k1']} K2 {got_a['k2']} "
                  f"({n_vg} value-and-grads), plain calls 0")

            vi = config_driver(tmp, "vi_lj55_coupled.yaml", over=dict(
                num_epochs=1, steps_per_epoch=LJ55C_STEPS))
            Pv = vi.vi_particles
            # per step: the reverse flow's kick and drift EGCLs, forward
            # (K1) and backward with parameter gradients (K2 p)
            want_b = dict(k1=2 * n_iter * LJ55C_STEPS, k2=0,
                          k2_params=2 * n_iter * LJ55C_STEPS, plain=0)
            step_s, losses = vi_epoch(vi, "vi_lj55_coupled", LJ55C_STEPS,
                                      want_b)
            require(Path("lj55_vi_coupled.cpt").exists(),
                    "no coupled checkpoint written")
            s_step = statistics.median(step_s[1:])
            phase("lj55", f"(b) vi_lj55_coupled.yaml on {card}: 1 epoch x "
                  f"{LJ55C_STEPS} steps of {Pv} particles (cut from 80 x "
                  f"100), {s_step:.5f} s/step (median of steps "
                  f"2-{LJ55C_STEPS}; first {step_s[0]:.4f} s); losses "
                  + ", ".join(f"{x:.2f}" for x in losses)
                  + f"; per step K1 {want_b['k1'] // LJ55C_STEPS} + K2 p "
                  f"{want_b['k2_params'] // LJ55C_STEPS} (kick + drift), "
                  "plain calls 0")

            runs = {}
            for label, chunk in (("chunked", 2), ("monolithic", 0)):
                m = config_driver(tmp, "sample_lj55.yaml", over=dict(
                    n_temps=4, chunk_temps=chunk, checkpoint_every=chunk,
                    output=f"coupled_{label}.npz"), dynamics=dict(
                    checkpoint_path="lj55_vi_coupled.cpt",
                    position_update="coupled"))
                reset_counts()
                res, secs = timed_sample(m)
                got = vi_launches()
                n_vg = 1 + 4 * 2 * 5
                want = dict(k1=2 * (n_iter + n_vg * n_iter),
                            k2=2 * n_vg * n_iter, k2_params=0, plain=0)
                require(got == want, f"coupled {label} launches {got} != "
                        f"{want}")
                check_smc(res, f"coupled {label}", P, 55)
                runs[label] = (res, secs, got)
            a, b = runs["chunked"][0], runs["monolithic"][0]
            fields = {f"particles[{k}]": (a.particles[k], b.particles[k])
                      for k in sorted(a.particles)}
            fields.update({f: (getattr(a, f), getattr(b, f)) for f in (
                "log_weights", "log_Z", "ess_history", "accept_history",
                "beta_history", "step_history")})
            diff = {f: float((x.double() - y.double()).abs().max())
                    for f, (x, y) in fields.items()
                    if not torch.equal(x, y)}
            phase("lj55", f"(c) sample_lj55.yaml, position_update coupled, "
                  f"from (b)'s checkpoint, 4 temps: chunked "
                  f"{runs['chunked'][1]:.3f} s, monolithic "
                  f"{runs['monolithic'][1]:.3f} s, log_Z "
                  f"{float(a.log_Z):.4f}; launches K1 "
                  f"{runs['chunked'][2]['k1']} K2 {runs['chunked'][2]['k2']}"
                  " each; chunked == monolithic bit for bit: "
                  + ("yes" if not diff else f"NO, max |diff| {diff}"))
            require(not diff, f"chunked and monolithic SMC differ: {diff}")
        finally:
            os.chdir(cwd)
    rec = allpairs_vs_plain("lj55", "sample_lj55 shape",
                            dict(B=P, N=55, nf=5, H=128), "bfloat16", 29,
                            ("fwd", "bwd"), plain_reps=(3, 1))
    torch.cuda.empty_cache()
    return dict(secs=secs_a, k1=got_a["k1"], k2=got_a["k2"],
                k1_coupled=want_b["k1"], rec=rec)


# LJ147 (the Mackay icosahedron after LJ55; Cambridge Cluster Database):
# vi_lj55.yaml's and sample_lj55.yaml's widths and options with the
# target's n_atoms 147, VI cut to 1 epoch of LJ147_STEPS steps of 256
# particles, SMC to 256 particles and 4 temperatures in one segment
LJ147_N, LJ147_P, LJ147_STEPS, LJ147_TEMPS = 147, 256, 5, 4
# the input-gradient K2 also timed at sample_lj55.yaml's 1024 particles
LJ147_K2_BIG = 1024


def blocks_device_ms(fn, kind, f32=False, **kw):
    """Device time of one block-pair launch (bf16, or with ``f32`` the f32
    block pairs): the main kernel, plus for the backward the second kernel
    that sums the partials (both from one trace)."""
    pre = "egcl_f32_blocks_" if f32 else "egcl_sm90_blocks_"
    main = pre + ("fwd_kernel" if kind == "fwd" else "bwd_params_kernel"
                  if f32 and kind == "bwd_params" else "bwd_kernel")
    return device_ms(fn, main if kind == "fwd" else
                     (main, pre + "finish_kernel"), **kw)


def lj147_phase(card):
    """LJ147 on the card through the port's driver, every EGCL on the
    bf16 block-pair kernels: (a) ``vi_lj55.yaml`` with ``n_atoms: 147``
    and 256 particles, cut to 1 epoch x LJ147_STEPS steps (5 K1 + 5 K2 p
    a step), then (b) ``sample_lj55.yaml`` with ``n_atoms: 147`` from (a)'s
    checkpoint at 256 particles and 4 temperatures in one segment
    (``chunk_temps: 4``): 5 + 41 x 5 K1 and 41 x 5 K2. No plain call and
    no one-molecule launch; beta 1, finite log_Z, particles and losses,
    all on the card. Then K1 and K2 p at B=256 and K2 at B=256 and 1024,
    N=147, against the plain version (B=256) and timed: CUDA events, the
    device time of the launch's kernels, the bound and the MUFU /
    elementwise floors."""
    import os
    import torch
    from enflow_tpu_torch.ops import egcl_allpairs as ops
    from enflow_tpu_torch.sample.smc import ess_from_log_weights

    cwd = os.getcwd()
    n_iter = 5
    target = dict(n_atoms=LJ147_N)
    with tempfile.TemporaryDirectory() as tmp:
        try:
            vi = config_driver(tmp, "vi_lj55.yaml", over=dict(
                num_epochs=1, steps_per_epoch=LJ147_STEPS,
                n_particles=LJ147_P), target=target,
                dynamics=dict(checkpoint_path="lj147_vi.cpt"))
            step_s, losses = time_vi_steps(vi)
            reset_counts()
            vi.train()
            torch.cuda.synchronize()
            got_a, one_a = blocks_launches()
            plain_a = plain_calls()
            want_a = dict(fwd=n_iter * LJ147_STEPS, bwd=0,
                          bwd_params=n_iter * LJ147_STEPS)
            require(len(step_s) == LJ147_STEPS, f"{len(step_s)} LJ147 steps")
            require(got_a == want_a and one_a == 0 and plain_a == 0,
                    f"LJ147 VI launches {got_a} (one-molecule {one_a}, plain"
                    f" {plain_a}) != {want_a}")
            require(all(math.isfinite(x) for x in losses),
                    f"non-finite LJ147 VI losses {losses}")
            require(Path("lj147_vi.cpt").exists(), "no LJ147 checkpoint")
            s_step = statistics.median(step_s[1:])
            phase("lj147", f"(a) vi_lj55.yaml at n_atoms {LJ147_N} on {card}"
                  f": 1 epoch x {LJ147_STEPS} steps of {vi.vi_particles} "
                  f"particles, {s_step:.5f} s/step (median of steps "
                  f"2-{LJ147_STEPS}; first {step_s[0]:.4f} s), "
                  f"{vi.vi_particles / s_step:.1f} particles/s; losses "
                  + ", ".join(f"{x:.2f}" for x in losses)
                  + f"; launches K1 {got_a['fwd']} K2 p "
                  f"{got_a['bwd_params']} on the block-pair kernels, "
                  "one-molecule 0, plain calls 0")

            smc = config_driver(tmp, "sample_lj55.yaml", over=dict(
                n_particles=LJ147_P, n_temps=LJ147_TEMPS,
                chunk_temps=LJ147_TEMPS, checkpoint_every=LJ147_TEMPS,
                output="lj147_samples.npz"), target=target,
                dynamics=dict(checkpoint_path="lj147_vi.cpt"))
            sec = smc.args["sampling"]
            reset_counts()
            res, secs = timed_sample(smc)
            got_b, one_b = blocks_launches()
            plain_b = plain_calls()
            n_vg = 1 + LJ147_TEMPS * sec["mcmc_steps"] * sec["n_leapfrog"]
            want_b = dict(fwd=n_iter + n_vg * n_iter, bwd=n_vg * n_iter,
                          bwd_params=0)
            require(got_b == want_b and one_b == 0 and plain_b == 0,
                    f"LJ147 SMC launches {got_b} (one-molecule {one_b}, "
                    f"plain {plain_b}) != {want_b}")
            check_smc(res, "lj147", LJ147_P, LJ147_N)
            outs = [res.particles[k] for k in sorted(res.particles)]
            outs += [res.log_weights, res.log_Z]
            require(all(t.is_cuda for t in outs),
                    "LJ147 SMC outputs are not on the card")
            require(Path("lj147_samples.npz").exists()
                    and not Path("lj147_samples.npz.state.npz").exists(),
                    "lj147: no samples, or a stage state left over")
            ess = float(ess_from_log_weights(res.log_weights))
            phase("lj147", f"(b) sample_lj55.yaml at n_atoms {LJ147_N} on "
                  f"{card} from (a)'s checkpoint: {LJ147_P} particles x "
                  f"{LJ147_TEMPS} temps in one segment: {secs:.3f} s, "
                  f"{LJ147_P / secs:.1f} samples/s, log_Z "
                  f"{float(res.log_Z):.4f}, final ESS {ess:.1f}, beta "
                  f"{float(res.beta_history[-1]):.6f}; launches K1 "
                  f"{got_b['fwd']} K2 {got_b['bwd']} ({n_vg} "
                  "value-and-grads) on the block-pair kernels, one-molecule"
                  " 0, plain calls 0; outputs on cuda")
        finally:
            os.chdir(cwd)
    del vi, smc, res
    torch.cuda.empty_cache()

    rec = {}
    for kind, B in (("fwd", LJ147_P), ("bwd_params", LJ147_P),
                    ("bwd", LJ147_P), ("bwd", LJ147_K2_BIG)):
        shape = dict(B=B, N=LJ147_N, nf=5, H=128)
        h, pos, box, mask_f, W, dagg, dfsum, mask = edge_inputs(
            shape, torch.bfloat16, seed=41)
        args = (h, pos, box, mask_f, W, dagg, dfsum)
        if kind == "fwd":
            kern = lambda: ops.allpairs_edges_fwd(h, pos, box, mask_f, W)
            plain = lambda: ops.allpairs_edges_plain(h, pos, box, mask_f, W)
            names = ("agg", "f_sum")
        else:
            params = kind == "bwd_params"
            kern = lambda p=params: ops.allpairs_edges_bwd(*args, params=p)
            plain = lambda p=params: ops.allpairs_edges_plain_bwd(*args,
                                                                  params=p)
            names = PARAM_OUT if params else ("dh", "dpos")
        ops.counts.reset()
        got = kern()
        torch.cuda.synchronize()
        launched, one = blocks_launches()
        require(launched[kind] == 1 and one == 0,
                f"lj147 {kind}: launches {launched}, one-molecule {one}")
        err, t_plain, note = None, None, "plain not run at this B"
        if B == LJ147_P:
            errs = rel_errs(names, got, plain())
            tol = {n: (TOL_PARAM if n in PARAM_OUT[2:] else TOL)["bfloat16"]
                   for n in names}
            ok = all(r <= tol[n] for n, (_, r) in errs.items())
            err = max(a for a, _ in errs.values())
            t_plain = cuda_time_ms(plain, reps=3, calls=1, warmup=1)
            note = ("vs plain max_abs/rel " + "  ".join(
                f"{n} {a:.2e}/{r:.1e}" for n, (a, r) in errs.items())
                + f" -> {'ok' if ok else 'FAIL'}; plain {t_plain:.4f} ms")
            require(ok, f"lj147 {kind} disagrees with plain")
            torch.cuda.empty_cache()
        del got
        ms = cuda_time_ms(kern, reps=10, calls=3)
        dev = blocks_device_ms(kern, kind)
        fl_f, fl_b, by_f, by_b = work(shape, "bfloat16", mask)
        fl, by = {"fwd": (fl_f, by_f), "bwd": (fl_b, by_b),
                  "bwd_params": work_params(shape, "bfloat16", mask)}[kind]
        b = bound(fl, by, PEAK_FLOPS["bfloat16"])
        floors = sfu_alu_floor(shape, mask)[kind]
        A, nwg = ops._blocks_launch_plan(ops._sm90_library(), LJ147_N, 5,
                                         128, kind)
        phase("lj147", f"{kind} bf16 B={B} N={LJ147_N} (blocks of {A} "
              f"atoms, {nwg} warpgroup(s) a block): {note}; time ms events "
              f"{ms:.4f} device {dev:.4f}, bound {b[0]:.4f} ({b[1]}, "
              f"{fl / 1e9:.2f} GFLOP), MUFU / elementwise floors "
              f"{floors[0]:.4f} / {floors[1]:.4f}")
        if B == LJ147_P:
            rec[kind] = dict(err=err, ms=ms, dev=dev, plain=t_plain,
                             bound=b)
        del h, pos, box, mask_f, W, dagg, dfsum, mask, args
        torch.cuda.empty_cache()
    return dict(k1=got_a["fwd"] + got_b["fwd"], k2=got_b["bwd"],
                k2_params=got_a["bwd_params"], rec=rec)


# phase lj147_f32: LJ147 in float32 (VI and SMC as phase lj147), then SMC
# at LJ561 (the Mackay icosahedron after 309) from a fresh flow, whose
# input-gradient K2 runs on the f32 block pairs (N > 519)
LJ561_N, LJ561_P = 561, 16


def lj147_f32_phase(card):
    """LJ147 in float32 through the port's driver (``compute_dtype:
    float32``): (a) ``vi_lj55.yaml`` with ``n_atoms: 147``, 256 particles,
    1 epoch x LJ147_STEPS steps: 5 f32 block-pair K1 + 5 f32 block-pair K2
    p a step; (b) ``sample_lj55.yaml`` at ``n_atoms: 147`` from (a)'s
    checkpoint, 256 particles, 4 temperatures in one segment: 210 f32
    block-pair K1 and 205 tiled f32 K2 (``bwd_f32_launches``: N=147 is
    within its one-molecule limit of 519); (c) ``sample_lj55.yaml`` at
    ``n_atoms: 561`` from a fresh flow, LJ561_P particles, 4 temperatures:
    210 f32 block-pair K1 and 205 f32 block-pair K2. No plain call and no
    other launch, beta 1, finite log_Z, particles and losses, outputs on
    the card. Then the f32 K1, K2 p and K2 at B=256, N=147 and the f32
    block-pair K1 and K2 at (c)'s shape against the plain version and
    timed (CUDA events, the device time of the launch's kernels, the
    bound)."""
    import os
    import torch
    from enflow_tpu_torch.ops import egcl_allpairs as ops
    from enflow_tpu_torch.sample.smc import ess_from_log_weights

    cwd = os.getcwd()
    n_iter = 5
    f32 = dict(compute_dtype="float32")
    runs = {}

    def counts():
        c = ops.counts
        every = {k: v for k, v in vars(c).items()
                 if k.endswith("_launches") and v}
        return every, plain_calls()

    with tempfile.TemporaryDirectory() as tmp:
        try:
            vi = config_driver(tmp, "vi_lj55.yaml", over=dict(
                num_epochs=1, steps_per_epoch=LJ147_STEPS,
                n_particles=LJ147_P), target=dict(n_atoms=LJ147_N),
                dynamics=dict(f32, checkpoint_path="lj147_f32_vi.cpt"))
            step_s, losses = time_vi_steps(vi)
            reset_counts()
            vi.train()
            torch.cuda.synchronize()
            got_a, plain_a = counts()
            want_a = dict(fwd_f32_blocks_launches=n_iter * LJ147_STEPS,
                          bwd_param_f32_blocks_launches=n_iter * LJ147_STEPS)
            require(len(step_s) == LJ147_STEPS,
                    f"{len(step_s)} LJ147 f32 steps")
            require(got_a == want_a and plain_a == 0,
                    f"LJ147 f32 VI launches {got_a} (plain {plain_a}) != "
                    f"{want_a}")
            require(all(math.isfinite(x) for x in losses),
                    f"non-finite LJ147 f32 VI losses {losses}")
            require(Path("lj147_f32_vi.cpt").exists(), "no checkpoint")
            s_step = statistics.median(step_s[1:])
            runs["vi"] = dict(s_step=s_step, launches=got_a)
            phase("lj147_f32", f"(a) vi_lj55.yaml at n_atoms {LJ147_N}, "
                  f"float32, on {card}: 1 epoch x {LJ147_STEPS} steps of "
                  f"{vi.vi_particles} particles, {s_step:.5f} s/step "
                  f"(median of steps 2-{LJ147_STEPS}; first "
                  f"{step_s[0]:.4f} s), {vi.vi_particles / s_step:.1f} "
                  "particles/s; losses " + ", ".join(
                      f"{x:.2f}" for x in losses)
                  + f"; launches {got_a}, plain calls 0")

            for label, N, P, ckpt, want_k2 in (
                    ("b", LJ147_N, LJ147_P, "lj147_f32_vi.cpt",
                     "bwd_f32_launches"),
                    ("c", LJ561_N, LJ561_P, None,
                     "bwd_f32_blocks_launches")):
                dyn = dict(f32, checkpoint_path=ckpt) if ckpt else dict(f32)
                out = f"lj{N}_f32_samples.npz"
                smc = config_driver(tmp, "sample_lj55.yaml", over=dict(
                    n_particles=P, n_temps=LJ147_TEMPS,
                    chunk_temps=LJ147_TEMPS, checkpoint_every=LJ147_TEMPS,
                    output=out), target=dict(n_atoms=N), dynamics=dyn)
                sec = smc.args["sampling"]
                reset_counts()
                res, secs = timed_sample(smc)
                got, plain = counts()
                n_vg = 1 + LJ147_TEMPS * sec["mcmc_steps"] * sec["n_leapfrog"]
                want = {"fwd_f32_blocks_launches": n_iter + n_vg * n_iter,
                        want_k2: n_vg * n_iter}
                require(got == want and plain == 0,
                        f"LJ{N} f32 SMC launches {got} (plain {plain}) != "
                        f"{want}")
                check_smc(res, f"lj{N} f32", P, N)
                outs = [res.particles[k] for k in sorted(res.particles)]
                outs += [res.log_weights, res.log_Z]
                require(all(t.is_cuda for t in outs),
                        f"LJ{N} f32 SMC outputs are not on the card")
                require(Path(out).exists()
                        and not Path(out + ".state.npz").exists(),
                        f"lj{N} f32: no samples, or a stage state left over")
                ess = float(ess_from_log_weights(res.log_weights))
                runs[label] = dict(secs=secs, launches=got, n_vg=n_vg)
                phase("lj147_f32", f"({label}) sample_lj55.yaml at n_atoms "
                      f"{N}, float32, on {card} "
                      + (f"from (a)'s checkpoint" if ckpt else
                         "from a fresh flow")
                      + f": {P} particles x {LJ147_TEMPS} temps in one "
                      f"segment: {secs:.3f} s, {P / secs:.1f} samples/s, "
                      f"log_Z {float(res.log_Z):.4f}, final ESS {ess:.1f}, "
                      f"beta {float(res.beta_history[-1]):.6f}; launches "
                      f"{got} ({n_vg} value-and-grads), plain calls 0; "
                      "outputs on cuda")
                del smc, res, outs
        finally:
            os.chdir(cwd)
    del vi
    torch.cuda.empty_cache()

    rec = {}
    for key, kind, B, N in (("fwd", "fwd", LJ147_P, LJ147_N),
                            ("bwd_params", "bwd_params", LJ147_P, LJ147_N),
                            ("bwd", "bwd", LJ147_P, LJ147_N),
                            ("fwd_561", "fwd", LJ561_P, LJ561_N),
                            ("bwd_blocks", "bwd", LJ561_P, LJ561_N)):
        shape = dict(B=B, N=N, nf=5, H=128)
        h, pos, box, mask_f, W, dagg, dfsum, mask = edge_inputs(
            shape, torch.float32, seed=47)
        args = (h, pos, box, mask_f, W, dagg, dfsum)
        if kind == "fwd":
            kern = lambda: ops.allpairs_edges_fwd(h, pos, box, mask_f, W)
            plain = lambda: ops.allpairs_edges_plain(h, pos, box, mask_f, W)
            names = ("agg", "f_sum")
        else:
            params = kind == "bwd_params"
            kern = lambda p=params: ops.allpairs_edges_bwd(*args, params=p)
            plain = lambda p=params: ops.allpairs_edges_plain_bwd(*args,
                                                                  params=p)
            names = PARAM_OUT if params else ("dh", "dpos")
        route = ops.route_for(N, 5, 128, 0, kind,
                              ops.largest_molecule(0, 5, 128, kind))
        ops.counts.reset()
        got = kern()
        torch.cuda.synchronize()
        launched, other = f32_blocks_launches()
        require((launched[kind], other) == ((1, 0) if route == "f32_blocks"
                                            else (0, 1)),
                f"lj147_f32 {key}: launches {launched} + {other}")
        errs = rel_errs(names, got, plain())
        del got
        tol = {n: (TOL_PARAM if n in PARAM_OUT[2:] else TOL)["float32"]
               for n in names}
        ok = all(r <= tol[n] for n, (_, r) in errs.items())
        err = max(a for a, _ in errs.values())
        t_plain = cuda_time_ms(plain, reps=3, calls=1, warmup=1)
        torch.cuda.empty_cache()
        require(ok, f"lj147_f32 {key} disagrees with plain: {errs}")
        ms = cuda_time_ms(kern, reps=5, calls=2)
        dev = (blocks_device_ms(kern, kind, True) if route == "f32_blocks"
               else device_ms(kern, kernel_key("float32", 128, kind)))
        fl_f, fl_b, by_f, by_b = work(shape, "float32", mask)
        fl, by = {"fwd": (fl_f, by_f), "bwd": (fl_b, by_b),
                  "bwd_params": work_params(shape, "float32", mask)}[kind]
        b = bound(fl, by, PEAK_FLOPS["float32"])
        if route == "f32_blocks":
            A, R = ops._f32_blocks_launch_plan(ops._f32_library(), N, 5, 128,
                                               kind)
            how = f"f32 block pairs: blocks of {A} atoms, {R} rows a tile"
        else:
            how = "the tiled f32 kernel, one molecule a tile"
        phase("lj147_f32", f"{kind} float32 B={B} N={N} ({how}): vs plain "
              "max_abs/rel " + "  ".join(
                  f"{n} {a:.2e}/{r:.1e}" for n, (a, r) in errs.items())
              + f" -> ok; time ms events {ms:.4f} device {dev:.4f}, plain "
              f"{t_plain:.4f}, bound {b[0]:.4f} ({b[1]}, {fl / 1e9:.2f} "
              f"GFLOP), {dev / b[0]:.1f}x the bound")
        rec[key] = dict(err=err, ms=ms, dev=dev, plain=t_plain, bound=b)
        del h, pos, box, mask_f, W, dagg, dfsum, mask, args
        torch.cuda.empty_cache()
    n = lambda run, key: runs[run]["launches"].get(key, 0)  # noqa: E731
    return dict(k1=(n("vi", "fwd_f32_blocks_launches")
                    + n("b", "fwd_f32_blocks_launches")),
                k1_561=n("c", "fwd_f32_blocks_launches"),
                k2_params=n("vi", "bwd_param_f32_blocks_launches"),
                k2=n("b", "bwd_f32_launches"),
                k2_blocks=n("c", "bwd_f32_blocks_launches"), rec=rec,
                runs=runs)


# 1 epoch of LJ55C_STEPS (vi_lj55_coupled.yaml), FLUID_STEPS
# (vi_fluid.yaml) and DW4_STEPS (vi_dw4.yaml) steps, every width as committed
LJ55C_STEPS, FLUID_STEPS, DW4_STEPS = 5, 5, 10
# phase wide: vi_lj55.yaml and sample_lj55.yaml with network.hidden_nf
# WIDE_H and nothing else changed (VI cut to 1 epoch x WIDE_STEPS steps of
# its 256 particles; SMC from that checkpoint, its 1024 particles at
# WIDE_TEMPS of its 16 temperatures in one segment), every EGCL on the bf16
# block pairs with streamed weights; then vi_lj13.yaml at hidden_nf
# WIDE13_H (1 x WIDE13_STEPS) and sample_lj13.yaml from its checkpoint,
# zero-padded to 128 on the one-molecule kernels
WIDE_H, WIDE_STEPS, WIDE_TEMPS = 256, 5, 4
WIDE13_H, WIDE13_STEPS = 96, 3
# the kernels timed (and held against the plain version) at N=55,
# H=WIDE_H: the VI's B and the SMC's
WIDE_B = (256, 1024)


def wide_tiles(B, N, A):
    """64-row tiles of a block-pair launch of B molecules of N atoms in
    blocks of A: each block pair's rows i != j in tiles of their own."""
    sizes = [min(A, N - a0) for a0 in range(0, N, A)]
    per = sum(-(-ni * (nj - (ib == jb)) // 64)
              for ib, ni in enumerate(sizes) for jb, nj in enumerate(sizes))
    return B * per


def wide_driver_paths(card):
    """Phase wide's driver paths (see WIDE_H): launches held exactly on the
    ``"wide"`` counters (LJ55) or the one-molecule counters with
    ``padded_launches`` (LJ13 at 96), no plain call;
    beta 1, finite log_Z and losses, outputs on the card. Returns the
    seconds and launches of each run."""
    import os
    import torch
    from enflow_tpu_torch.sample.smc import ess_from_log_weights

    cwd = os.getcwd()
    n_iter = 5
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        try:
            net = dict(network=dict(hidden_nf=WIDE_H, node_nf=5),
                       checkpoint_path="lj55_wide_vi.cpt")
            vi = config_driver(tmp, "vi_lj55.yaml", over=dict(
                num_epochs=1, steps_per_epoch=WIDE_STEPS), dynamics=net)
            require(vi.hidden_nf == WIDE_H, f"hidden_nf {vi.hidden_nf}")
            step_s, losses = time_vi_steps(vi)
            reset_counts()
            vi.train()
            torch.cuda.synchronize()
            got, plain = launched(), plain_calls()
            want = dict(fwd_wide_launches=n_iter * WIDE_STEPS,
                        bwd_param_wide_launches=n_iter * WIDE_STEPS)
            require(len(step_s) == WIDE_STEPS and got == want and plain == 0,
                    f"wide VI: {len(step_s)} steps, launches {got} != "
                    f"{want}, plain {plain}")
            require(all(math.isfinite(x) for x in losses),
                    f"non-finite wide VI losses {losses}")
            require(Path("lj55_wide_vi.cpt").exists(), "no wide checkpoint")
            out["vi"] = dict(s_step=statistics.median(step_s[1:]),
                             first=step_s[0], launches=got,
                             P=vi.vi_particles)
            phase("wide", f"(a) vi_lj55.yaml at hidden_nf {WIDE_H} on {card}"
                  f": 1 epoch x {WIDE_STEPS} steps of {vi.vi_particles} "
                  f"particles, {out['vi']['s_step']:.5f} s/step (median of "
                  f"steps 2-{WIDE_STEPS}; first {step_s[0]:.4f} s); losses "
                  + ", ".join(f"{x:.2f}" for x in losses)
                  + f"; launches {got}, plain calls 0")

            smc = config_driver(tmp, "sample_lj55.yaml", over=dict(
                n_temps=WIDE_TEMPS, chunk_temps=WIDE_TEMPS,
                checkpoint_every=WIDE_TEMPS, output="lj55_wide.npz"),
                dynamics=net)
            sec = smc.args["sampling"]
            P = sec["n_particles"]
            reset_counts()
            res, secs = timed_sample(smc)
            got, plain = launched(), plain_calls()
            n_vg = 1 + WIDE_TEMPS * sec["mcmc_steps"] * sec["n_leapfrog"]
            want = dict(fwd_wide_launches=n_iter + n_vg * n_iter,
                        bwd_wide_launches=n_vg * n_iter)
            require(got == want and plain == 0, f"wide SMC launches {got} "
                    f"!= {want}, plain {plain}")
            check_smc(res, "wide sample_lj55", P, 55)
            outs = [res.particles[k] for k in sorted(res.particles)]
            require(all(t.is_cuda for t in outs + [res.log_weights,
                                                   res.log_Z]),
                    "wide SMC outputs are not on the card")
            ess = float(ess_from_log_weights(res.log_weights))
            out["smc"] = dict(secs=secs, launches=got, P=P)
            phase("wide", f"(b) sample_lj55.yaml at hidden_nf {WIDE_H} on "
                  f"{card} from (a)'s checkpoint: {P} particles x "
                  f"{WIDE_TEMPS} temps in one segment: {secs:.3f} s, "
                  f"{P / secs:.1f} samples/s, log_Z {float(res.log_Z):.4f}, "
                  f"final ESS {ess:.1f}, beta "
                  f"{float(res.beta_history[-1]):.6f}; launches {got} "
                  f"({n_vg} value-and-grads), plain calls 0; "
                  "outputs on cuda")
            del vi, smc, res, outs
            torch.cuda.empty_cache()

            net = dict(network=dict(hidden_nf=WIDE13_H, node_nf=5),
                       checkpoint_path="lj13_h96_vi.cpt")
            vi = config_driver(tmp, "vi_lj13.yaml", over=dict(
                num_epochs=1, steps_per_epoch=WIDE13_STEPS), dynamics=net)
            step_s, losses = time_vi_steps(vi)
            reset_counts()
            vi.train()
            torch.cuda.synchronize()
            got, plain = launched(), plain_calls()
            want = dict(fwd_launches=n_iter * WIDE13_STEPS,
                        bwd_param_launches=n_iter * WIDE13_STEPS,
                        padded_launches=2 * n_iter * WIDE13_STEPS)
            require(len(step_s) == WIDE13_STEPS and got == want
                    and plain == 0, f"LJ13 H={WIDE13_H} VI launches {got} "
                    f"!= {want}, plain {plain}")
            require(all(math.isfinite(x) for x in losses),
                    f"non-finite LJ13 H={WIDE13_H} losses {losses}")
            smc = config_driver(tmp, "sample_lj13.yaml", over=dict(
                output="lj13_h96.npz"), dynamics=net)
            sec = smc.args["sampling"]
            P13 = sec["n_particles"]
            reset_counts()
            res, secs13 = timed_sample(smc)
            got13, plain = launched(), plain_calls()
            n_vg = 1 + sec["n_temps"] * sec["mcmc_steps"] * sec["n_leapfrog"]
            want13 = dict(fwd_launches=n_iter + n_vg * n_iter,
                          bwd_launches=n_vg * n_iter,
                          padded_launches=n_iter + 2 * n_vg * n_iter)
            require(got13 == want13 and plain == 0, f"LJ13 H={WIDE13_H} SMC "
                    f"launches {got13} != {want13}, plain {plain}")
            check_smc(res, f"sample_lj13 H={WIDE13_H}", P13, 13)
            require(res.log_Z.is_cuda and res.particles["pos"].is_cuda,
                    "LJ13 H=96 SMC outputs are not on the card")
            out["lj13"] = dict(s_step=statistics.median(step_s[1:]),
                               vi=got, secs=secs13, smc=got13)
            phase("wide", f"(c) vi_lj13.yaml at hidden_nf {WIDE13_H} "
                  f"(zero-padded to 128) on {card}: 1 epoch x {WIDE13_STEPS} "
                  f"steps of {vi.vi_particles} particles, "
                  f"{out['lj13']['s_step']:.5f} s/step; losses "
                  + ", ".join(f"{x:.2f}" for x in losses)
                  + f"; launches {got}; then sample_lj13.yaml from its "
                  f"checkpoint: {P13} particles, {secs13:.3f} s, log_Z "
                  f"{float(res.log_Z):.4f}, beta "
                  f"{float(res.beta_history[-1]):.6f}; launches {got13}, "
                  "plain calls 0; outputs on cuda")
        finally:
            os.chdir(cwd)
    return out


def wide_phase(card):
    """Phase wide: the driver paths (``wide_driver_paths``), then bf16 K1,
    K2 and K2 p at N=55, H=WIDE_H on the streamed block pairs at B=256
    (the VI's batch) and B=1024 (the SMC run's), each against the plain
    version (read per element, ``step_errs``) and timed beside it: CUDA
    events, device time, the bound, the L2 bytes the slabs read (and K2
    p's partials), the plan; the partials' sum timed; the padded launches'
    cost at H=96 against H=128 at the same shapes; each run's kernel
    share."""
    import torch
    from enflow_tpu_torch.ops import build
    from enflow_tpu_torch.ops import egcl_allpairs as ops

    paths = wide_driver_paths(card)
    lib = ops._sm90_library()
    rec = {}
    for B in WIDE_B:
        shape = dict(B=B, N=55, nf=5, H=WIDE_H)
        h, pos, box, mask_f, W, dagg, dfsum, mask = edge_inputs(
            shape, torch.bfloat16, seed=47)
        args = (h, pos, box, mask_f, W, dagg, dfsum)
        for kind in ("fwd", "bwd", "bwd_params"):
            if kind == "fwd":
                kern = lambda: ops.allpairs_edges_fwd(*args[:5])
                plain = lambda: ops.allpairs_edges_plain(*args[:5])
                names = ("agg", "f_sum")
            else:
                p = kind == "bwd_params"
                kern = lambda p=p: ops.allpairs_edges_bwd(*args, params=p)
                plain = lambda p=p: ops.allpairs_edges_plain_bwd(*args,
                                                                 params=p)
                names = PARAM_OUT if p else ("dh", "dpos")
            ops.counts.reset()
            got = kern()
            torch.cuda.synchronize()
            require(launched() == {launch_counter(kind, "wide"): 1},
                    f"wide {kind} B={B}: launches {launched()}")
            errs = step_errs(names, got, plain(), plain_terms(args)
                             if kind == "bwd_params" else None)
            ok = steps_ok(errs)
            err = max(a for a, _, _ in errs.values())
            del got
            torch.cuda.empty_cache()
            t_plain = cuda_time_ms(plain, reps=3, calls=1, warmup=1)
            note = (f"vs plain {steps_text(errs)} -> "
                    f"{'ok' if ok else 'FAIL'}; plain {t_plain:.4f} ms")
            require(ok, f"wide {kind} B={B} disagrees with plain: {errs}")
            torch.cuda.empty_cache()
            ms = cuda_time_ms(kern, reps=5, calls=3)
            dev = blocks_device_ms(kern, kind)
            fl_f, fl_b, by_f, by_b = work(shape, "bfloat16", mask)
            fl, by = {"fwd": (fl_f, by_f), "bwd": (fl_b, by_b),
                      "bwd_params": work_params(shape, "bfloat16",
                                                mask)}[kind]
            b = bound(fl, by, PEAK_FLOPS["bfloat16"])
            A, nwg = ops._blocks_launch_plan(lib, 55, 5, WIDE_H, kind)
            tiles = wide_tiles(B, 55, A)
            # each tile reads its products' slabs: 2 H^2 bytes a product
            slab_bytes = tiles * (2 if kind == "fwd" else 4) * 2 * WIDE_H ** 2
            # K2 p also reads and writes dW2 and dW3 (2 H^2 f32) a tile
            part_bytes = tiles * 16 * WIDE_H ** 2 if kind == "bwd_params" \
                else 0
            phase("wide", f"{kind} bf16 B={B} N=55 H={WIDE_H} (blocks of {A} "
                  f"atoms, {nwg} warpgroup a block, {tiles} tiles): {note}; "
                  f"time ms events {ms:.4f} device {dev:.4f}, bound "
                  f"{b[0]:.4f} ({b[1]}, {fl / 1e9:.2f} GFLOP, {by / 1e6:.2f} "
                  f"MB); L2 reads of the weight slabs {slab_bytes / 1e9:.3f} "
                  f"GB" + (f", of K2 p's partials (read and written) "
                           f"{part_bytes / 1e9:.3f} GB" if part_bytes else ""))
            rec[(kind, B)] = dict(err=err, ms=ms, dev=dev, plain=t_plain,
                                  bound=b, A=A, tiles=tiles,
                                  l2=slab_bytes + part_bytes)
        del h, pos, box, mask_f, W, dagg, dfsum, mask, args
        torch.cuda.empty_cache()
    # K2 p's partials: one slice a warpgroup of the grid, summed by the
    # wrapper
    A, nwg = ops._blocks_launch_plan(lib, 55, 5, WIDE_H, "bwd_params")
    n_sm = build.multiprocessors("cuda")
    slices = lib.egcl_sm90_blocks_param_slices(WIDE_B[0], 55, A, nwg, n_sm)
    P = lib.egcl_part_size(5, WIDE_H)
    part = torch.randn((slices, lib.egcl_sm90_slice_floats(5, WIDE_H)),
                       device="cuda")
    t_sum = cuda_time_ms(lambda: part[:, :P].sum(dim=0))
    phase("wide", f"K2 p's partials at H={WIDE_H}: {slices} slices x {P} "
          f"floats ({slices * P * 4 / 1e6:.1f} MB), their sum {t_sum:.4f} ms")
    del part
    # the padded launches' cost: H=96 (run at 128) against H=128, at
    # LJ13's SMC / VI batches and at LJ55's VI batch
    for kind, B, N in (("fwd", 1024, 13), ("bwd", 1024, 13),
                       ("bwd_params", 512, 13), ("fwd", 256, 55),
                       ("bwd_params", 256, 55)):
        t = {}
        for H in (WIDE13_H, 128):
            a = edge_inputs(dict(B=B, N=N, nf=5, H=H), torch.bfloat16,
                            seed=53)[:7]
            ins = a[:5] if kind == "fwd" else a
            kern = ((lambda: ops.allpairs_edges_fwd(*ins))
                    if kind == "fwd" else (lambda p=kind == "bwd_params":
                                           ops.allpairs_edges_bwd(
                                               *ins, params=p)))
            names = (("agg", "f_sum") if kind == "fwd" else PARAM_OUT
                     if kind == "bwd_params" else ("dh", "dpos"))
            plain = (ops.allpairs_edges_plain(*ins) if kind == "fwd" else
                     ops.allpairs_edges_plain_bwd(
                         *ins, params=kind == "bwd_params"))
            errs = step_errs(names, kern(), plain, plain_terms(ins)
                             if kind == "bwd_params" else None)
            t[H] = (cuda_time_ms(kern, reps=10, calls=5), errs)
            del a, ins, plain
        padded, full = t[WIDE13_H], t[128]
        require(steps_ok(padded[1]) and steps_ok(full[1]),
                f"padded cost {kind}: a launch disagrees with plain")
        phase("wide", f"padded cost {kind} bf16 B={B} N={N}: H={WIDE13_H} "
              f"(zero-padded to 128) {padded[0]:.4f} ms, H=128 "
              f"{full[0]:.4f} ms ({padded[0] / full[0]:.3f}x)")
    vi, smc = paths["vi"], paths["smc"]
    k_vi = 5 * (rec[("fwd", WIDE_B[0])]["dev"]
                + rec[("bwd_params", WIDE_B[0])]["dev"]) / 1e3
    k_smc = (smc["launches"]["fwd_wide_launches"]
             * rec[("fwd", WIDE_B[1])]["dev"]
             + smc["launches"]["bwd_wide_launches"]
             * rec[("bwd", WIDE_B[1])]["dev"]) / 1e3
    phase("wide", f"kernel share: VI {vi['s_step']:.5f} s a step, 5 x (K1 + "
          f"K2 p) device {k_vi:.5f} s ({k_vi / vi['s_step']:.1%}); SMC "
          f"{smc['secs']:.3f} s, K1 + K2 launches x device {k_smc:.3f} s "
          f"({k_smc / smc['secs']:.1%})")
    return dict(k1=vi["launches"]["fwd_wide_launches"],
                k1_smc=smc["launches"]["fwd_wide_launches"],
                k2=smc["launches"]["bwd_wide_launches"],
                k2_params=vi["launches"]["bwd_param_wide_launches"], rec=rec)


# the f32 all-pairs shapes: vi_dw4.yaml's 512 particles of DW4, and
# vi_ala2.yaml's 256 of alanine dipeptide (22 atoms, nf=4, H=128)
DW4 = dict(B=512, N=4, nf=2, H=64)
ALA2 = dict(B=256, N=22, nf=4, H=128)


def vi_config_phase(card, name, config, steps, per_step, shape, dname,
                    check=None, after=None, kinds=("fwd", "bwd_params"),
                    **vs):
    """``example/<config>`` cut to 1 epoch x ``steps`` steps: ``per_step``
    K1 and K2 p launches a step, finite losses, a checkpoint; ``after``
    (given the driver) runs next in the same working directory. Then the
    ``kinds`` at ``shape`` against their plain version, timed
    (``allpairs_vs_plain`` with the options ``vs``)."""
    import os

    cwd = os.getcwd()
    extra = None
    with tempfile.TemporaryDirectory() as tmp:
        try:
            main = config_driver(tmp, config, over=dict(
                num_epochs=1, steps_per_epoch=steps))
            if check:
                check(main)
            want = dict(k1=per_step * steps, k2=0,
                        k2_params=per_step * steps, plain=0)
            step_s, losses = vi_epoch(main, config, steps, want)
            ckpt = main.checkpoint_path
            require(Path(ckpt).exists(), f"{config}: no checkpoint")
            if after:
                extra = after(main)
        finally:
            os.chdir(cwd)
    s_step = statistics.median(step_s[1:])
    P = main.vi_particles
    phase(name, f"{config} on {card}: 1 epoch x {steps} steps of {P} "
          f"particles, {s_step:.5f} s/step (median of steps 2-{steps}; "
          f"first {step_s[0]:.4f} s), {P / s_step:.1f} particles/s; losses "
          + ", ".join(f"{x:.2f}" for x in losses)
          + f"; per step K1 {per_step} + K2 p {per_step}, plain calls 0")
    rec = allpairs_vs_plain(name, f"{config} shape", shape, dname, 31, kinds,
                            **vs)
    return dict(s_step=s_step, launches=want, rec=rec, after=extra)

# phase wide_f32: vi_ala2.yaml and sample_ala2.yaml at hidden_nf
# WIDE_F32_H, every EGCL on the f32 block pairs with streamed weights; then
# the f32 K1, K2 and K2 p at each H of WIDE_F32_HS (192 and 256, and 160
# and 200 zero-padded up) and each shape of WIDE_F32_SHAPES: vi_ala2's and
# sample_ala2's batches at N=22, LJ55 at B=64 and LJ147 at B=16
WIDE_F32_H = 256
WIDE_F32_HS = (192, 256, 160, 200)
WIDE_F32_SHAPES = (("vi_ala2", dict(B=256, N=22, nf=4)),
                   ("sample_ala2", dict(B=2048, N=22, nf=4)),
                   ("lj55", dict(B=64, N=55, nf=5)),
                   ("lj147", dict(B=16, N=147, nf=5)))
# (shape, kind) of the kernels line, at WIDE_F32_H: each timed beside its
# plain version too
WIDE_F32_TIMED = (("vi_ala2", "fwd"), ("vi_ala2", "bwd_params"),
                  ("sample_ala2", "fwd"), ("sample_ala2", "bwd"))


def wide_f32_driver_paths(card):
    """Phase wide_f32's driver paths: (a) ``vi_ala2.yaml`` at
    ``hidden_nf: WIDE_F32_H`` cut to 1 epoch x FF_STEPS, 5 K1 + 5 K2 p a
    step exactly on the ``*_f32_wide_launches`` counters; (b)
    ``sample_ala2.yaml`` at the same width from (a)'s checkpoint, as
    committed otherwise: 260 K1 + 255 K2 there; no other counter, no plain
    call, beta 1, finite log_Z and losses, float32 outputs on the card.
    Returns the seconds and launches of each run."""
    import os
    import torch

    cwd = os.getcwd()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        try:
            net = dict(network=dict(hidden_nf=WIDE_F32_H, node_nf=4))
            vi = config_driver(tmp, "vi_ala2.yaml", over=dict(
                num_epochs=1, steps_per_epoch=FF_STEPS), dynamics=net)
            require(vi.hidden_nf == WIDE_F32_H and vi.vi_n_atoms == 22,
                    f"vi_ala2 at hidden_nf {vi.hidden_nf}, "
                    f"{vi.vi_n_atoms} atoms")
            n_iter = vi.n_iter
            step_s, losses = time_vi_steps(vi)
            reset_counts()
            vi.train()
            torch.cuda.synchronize()
            got, plain = launched(), plain_calls()
            want = dict(fwd_f32_wide_launches=n_iter * FF_STEPS,
                        bwd_param_f32_wide_launches=n_iter * FF_STEPS)
            require(len(step_s) == FF_STEPS and got == want and plain == 0,
                    f"vi_ala2 at {WIDE_F32_H}: {len(step_s)} steps, "
                    f"launches {got} != {want}, plain {plain}")
            require(all(math.isfinite(x) for x in losses),
                    f"non-finite vi_ala2 losses at {WIDE_F32_H}: {losses}")
            require(Path(vi.checkpoint_path).exists(),
                    "vi_ala2 at 256: no checkpoint")
            out["vi"] = dict(s_step=statistics.median(step_s[1:]),
                             first=step_s[0], launches=got,
                             P=vi.vi_particles)
            phase("wide_f32", f"(a) vi_ala2.yaml at hidden_nf {WIDE_F32_H} "
                  f"on {card}: 1 epoch x {FF_STEPS} steps of "
                  f"{vi.vi_particles} particles, float32, "
                  f"{out['vi']['s_step']:.5f} s/step (median of steps "
                  f"2-{FF_STEPS}; first {step_s[0]:.4f} s); losses "
                  + ", ".join(f"{x:.2f}" for x in losses)
                  + f"; launches {got}, plain calls 0; checkpoint "
                  f"{Path(vi.checkpoint_path).name}")

            smc = config_driver(tmp, "sample_ala2.yaml", dynamics=net)
            sec = smc.args["sampling"]
            P = sec["n_particles"]
            reset_counts()
            res, secs = timed_sample(smc)
            got, plain = launched(), plain_calls()
            n_vg = 1 + sec["n_temps"] * sec["mcmc_steps"] * sec["n_leapfrog"]
            want = dict(fwd_f32_wide_launches=n_iter + n_vg * n_iter,
                        bwd_f32_wide_launches=n_vg * n_iter)
            require(got == want and plain == 0, f"sample_ala2 at "
                    f"{WIDE_F32_H}: launches {got} != {want}, plain {plain}")
            check_smc(res, f"sample_ala2 at {WIDE_F32_H}", P, 22)
            pos = res.particles["pos"]
            require(pos.is_cuda and pos.dtype == torch.float32
                    and res.log_Z.is_cuda and res.log_weights.is_cuda,
                    "sample_ala2 at 256: outputs not float32 on the card")
            out["smc"] = dict(secs=secs, launches=got, P=P)
            phase("wide_f32", f"(b) sample_ala2.yaml at hidden_nf "
                  f"{WIDE_F32_H} on {card} from (a)'s checkpoint: {P} "
                  f"particles x {sec['n_temps']} temps, float32, "
                  f"{secs:.3f} s, log_Z {float(res.log_Z):.4f}, beta "
                  f"{float(res.beta_history[-1]):.6f}; launches {got} "
                  f"({n_vg} value-and-grads), plain calls 0; outputs on "
                  "cuda")
            del vi, smc, res, pos
            torch.cuda.empty_cache()
        finally:
            os.chdir(cwd)
    return out


def wide_f32_phase(card):
    """Phase wide_f32: the driver paths (``wide_f32_driver_paths``), then
    f32 K1, K2 and K2 p on the streamed f32 block pairs at each H of
    WIDE_F32_HS and shape of WIDE_F32_SHAPES: one launch on its counter
    (and ``padded_launches`` at 160 and 200), against the plain version
    (outputs to TOL, the parameter gradients' f32 sums to TOL_PARAM), a
    second launch bitwise equal, CUDA events and device time beside the
    bound and the plan; the plain version timed at WIDE_F32_TIMED; the
    library's plans at H = 128 (LJ147), 192 and 256; the kernel share of
    each driver run."""
    import torch
    from enflow_tpu_torch.ops import egcl_allpairs as ops

    paths = wide_f32_driver_paths(card)
    lib = ops._f32_library()
    names = {"fwd": ("agg", "f_sum"), "bwd": ("dh", "dpos"),
             "bwd_params": PARAM_OUT}
    plans = {f"H={H} N={N} nf={nf}": {
        k: ops._f32_blocks_launch_plan(lib, N, nf, H, k) for k in names}
        for H, N, nf in ((128, 147, 5), (192, 22, 4), (256, 22, 4),
                         (192, 147, 5), (256, 147, 5))}
    phase("wide_f32", "plans (atoms a block, rows a row tile): " + "; ".join(
        f"{k} {v}" for k, v in plans.items()))
    rec, bad = {}, []
    for H in WIDE_F32_HS:
        Hp = ops.padded_width(H)
        for sname, base in WIDE_F32_SHAPES:
            shape = dict(base, H=H)
            h, pos, box, mask_f, W, dagg, dfsum, mask = edge_inputs(
                shape, torch.float32, seed=61 + H)
            args = (h, pos, box, mask_f, W, dagg, dfsum)
            for kind in ("fwd", "bwd", "bwd_params"):
                run = ((lambda: ops.allpairs_edges_fwd(*args[:5]))
                       if kind == "fwd" else (lambda p=kind == "bwd_params":
                                              ops.allpairs_edges_bwd(
                                                  *args, params=p)))
                plain = ((lambda: ops.allpairs_edges_plain(*args[:5]))
                         if kind == "fwd" else
                         (lambda p=kind == "bwd_params":
                          ops.allpairs_edges_plain_bwd(*args, params=p)))
                ops.counts.reset()
                got = run()
                torch.cuda.synchronize()
                counted = launched()
                want = {launch_counter(kind, "f32_wide"): 1}
                if Hp != H:
                    want["padded_launches"] = 1
                errs = rel_errs(names[kind], got, plain())
                tol = {n: (TOL_PARAM if n in PARAM_OUT[2:] else
                           TOL)["float32"] for n in names[kind]}
                same = all(bool(torch.equal(a, b))
                           for a, b in zip(got, run()))
                del got
                torch.cuda.empty_cache()
                ok = (counted == want and same and all(
                    r <= tol[n] for n, (_, r) in errs.items()))
                ms = cuda_time_ms(run, reps=3, calls=2, warmup=1)
                dev = blocks_device_ms(run, kind, f32=True, calls=5,
                                       warmup=1)
                fl_f, fl_b, by_f, by_b = work(shape, "float32", mask)
                fl, by = {"fwd": (fl_f, by_f), "bwd": (fl_b, by_b),
                          "bwd_params": work_params(shape, "float32",
                                                    mask)}[kind]
                b = bound(fl, by, PEAK_FLOPS["float32"])
                t_plain = None
                if H == WIDE_F32_H and (sname, kind) in WIDE_F32_TIMED:
                    t_plain = cuda_time_ms(plain, reps=3, calls=1, warmup=1)
                    torch.cuda.empty_cache()
                plan = ops._f32_blocks_launch_plan(lib, shape["N"],
                                                   shape["nf"], Hp, kind)
                phase("wide_f32", f"{kind} f32 {sname} B={shape['B']} "
                      f"N={shape['N']} nf={shape['nf']} H={H} (run at {Hp}; "
                      f"plan {plan}): launches {counted}; max_abs/rel err "
                      + "  ".join(f"{n} {a:.2e}/{r:.1e}"
                                  for n, (a, r) in errs.items())
                      + f"; a second launch gives the same bits: {same}; "
                      f"time ms events {ms:.4f} device {dev:.4f}"
                      + (f" plain {t_plain:.4f}" if t_plain else "")
                      + f", bound {b[0]:.4f} ({b[1]}, {fl / 1e9:.2f} GFLOP, "
                      f"{by / 1e6:.2f} MB; device {dev / b[0]:.1f}x) -> "
                      f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    bad.append((H, sname, kind))
                rec[(kind, H, sname)] = dict(
                    err=max(a for a, _ in errs.values()), ms=ms, dev=dev,
                    plain=t_plain, bound=b, plan=plan)
            del h, pos, box, mask_f, W, dagg, dfsum, mask, args
            torch.cuda.empty_cache()
    require(not bad, f"f32 wide kernels disagree with plain: {bad}")
    vi, smc = paths["vi"], paths["smc"]
    r = lambda kind, sname: rec[(kind, WIDE_F32_H, sname)]["dev"]
    k_vi = vi["launches"]["fwd_f32_wide_launches"] / FF_STEPS * (
        r("fwd", "vi_ala2") + r("bwd_params", "vi_ala2")) / 1e3
    k_smc = (smc["launches"]["fwd_f32_wide_launches"]
             * r("fwd", "sample_ala2")
             + smc["launches"]["bwd_f32_wide_launches"]
             * r("bwd", "sample_ala2")) / 1e3
    phase("wide_f32", f"kernel share: vi_ala2 {vi['s_step']:.5f} s a step, "
          f"5 x (K1 + K2 p) device {k_vi:.5f} s ({k_vi / vi['s_step']:.1%});"
          f" sample_ala2 {smc['secs']:.3f} s, K1 + K2 launches x device "
          f"{k_smc:.3f} s ({k_smc / smc['secs']:.1%})")
    return dict(k1=vi["launches"]["fwd_f32_wide_launches"],
                k1_smc=smc["launches"]["fwd_f32_wide_launches"],
                k2=smc["launches"]["bwd_f32_wide_launches"],
                k2_params=vi["launches"]["bwd_param_f32_wide_launches"],
                rec=rec)


# Phase wide_nf: the all-pairs EGCL at wide node features (route
# "wide_nf" / "f32_wide_nf"). (a) the kernels at the reference's wide-nf
# shapes (RESULTS.md: B=1024, N=13 at nf = H = 128 and nf = H = 256; K2 p
# at B=512) and at LJ55 / LJ147 (B=16, several blocks a molecule), in f32
# also at the driver paths' batches; (b) the seam; (c) the driver paths.
NF_SHAPES = (("ref128", dict(B=1024, N=13, nf=128, H=128)),
             ("ref256", dict(B=1024, N=13, nf=256, H=256)),
             ("lj55", dict(B=16, N=55, nf=128, H=128, n_pad=2)),
             ("lj147", dict(B=16, N=147, nf=128, H=128, n_pad=3)))
# (K2 p at the VI's B=512 is ref128's)
NF_F32_DRIVER = (("vi512", dict(B=512, N=13, nf=128, H=128), ("fwd",)),
                 ("smc256", dict(B=256, N=13, nf=128, H=128), ("bwd",)))
NF_KP_B = 512
NF_SEAM = dict(B=64, N=13)
NF_VI_STEPS = 3
NF_SMC = dict(n_particles=256, n_temps=4)


def nf_keys(dname, kind):
    """The kernels of one wide-nf launch (substrings of their names for
    ``device_ms_each``): the projections, the block pairs, and for the
    backward the j-side sums, dh and (K2 p) dW1's splits."""
    pairs = ("egcl_sm90_blocks_" + ("fwd" if kind == "fwd" else "bwd")
             if dname == "bfloat16" else
             "egcl_f32_blocks_fwd" if kind == "fwd" else "egcl_f32_wide_nf")
    keys = ("egcl_nf_proj", pairs)
    if kind != "fwd":
        keys += ("egcl_nf_jsum", "egcl_nf_dh")
    if kind == "bwd_params":
        keys += ("egcl_nf_dw1",)
    return keys


def nf_vs_plain(label, shape, dname, kind, seed=61, route="entry"):
    """One launch of ``kind`` at ``shape`` against the plain version: bf16
    read per element (``step_errs``), f32 against TOL / TOL_PARAM; a second
    launch must give the same bits. ``route`` ``"entry"``: through the
    wrapper's entry point, on the wide-nf counter of its dtype alone;
    ``"parent"``: through the entry point on another route's counter;
    ``"wide_nf"``: the wide-nf route forced. Returns (the launch, its
    outputs, max abs err, reading text, ok, the mask, the plain call)."""
    import torch
    from enflow_tpu_torch.ops import egcl_allpairs as ops
    dt = getattr(torch, dname)
    h, pos, box, mf, W, dagg, dfsum, mask = edge_inputs(shape, dt, seed)
    args = (h, pos, box, mf, W, dagg, dfsum)
    ins = args[:5] if kind == "fwd" else args
    if route == "wide_nf":
        kern = lambda: ops.allpairs_edges_wide_nf(kind, *ins)
    elif kind == "fwd":
        kern = lambda: ops.allpairs_edges_fwd(*ins)
    else:
        kern = lambda: ops.allpairs_edges_bwd(*ins,
                                              params=kind == "bwd_params")
    plain = ((lambda: ops.allpairs_edges_plain(*ins)) if kind == "fwd" else
             (lambda: ops.allpairs_edges_plain_bwd(
                 *ins, params=kind == "bwd_params")))
    names = (("agg", "f_sum") if kind == "fwd" else PARAM_OUT
             if kind == "bwd_params" else ("dh", "dpos"))
    code = 1 if dname == "bfloat16" else 0
    ops.counts.reset()
    got = kern()
    torch.cuda.synchronize()
    nf_counter = launch_counter(kind, ops.WIDE_NF_ROUTE[code])
    if route == "entry":
        want_c = {nf_counter: 1}
        if ops.padded_width(shape["H"]) != shape["H"]:
            want_c["padded_launches"] = 1
        require(launched() == want_c, f"wide_nf {label} {kind} {dname}: "
                f"launches {launched()} != {want_c}")
    elif route == "parent":
        require(len(launched()) == 1 and nf_counter not in launched(),
                f"{label} {kind} {dname}: launches {launched()}")
    want = plain()
    if code:
        errs = step_errs(names, got, want, plain_terms(args)
                         if kind == "bwd_params" else None)
        ok, text = steps_ok(errs), steps_text(errs)
        err = max(a for a, _, _ in errs.values())
    else:
        errs = rel_errs(names, got, want)
        ok = all(r <= (TOL_PARAM if n in PARAM_OUT[2:] else TOL)[dname]
                 for n, (_, r) in errs.items())
        text = "  ".join(f"{n} {a:.2e}/{r:.1e}" for n, (a, r) in errs.items())
        err = max(a for a, _ in errs.values())
    same = all(bool(torch.equal(a, b)) for a, b in zip(got, kern()))
    del want
    return kern, got, err, f"{text}; a second launch gives the same bits: " \
        f"{same}", ok and same, mask, plain


def nf_kernels(card):
    """(a): K1, K2 and K2 p at NF_SHAPES (K2 p at B=NF_KP_B where B is
    1024) and, in f32, at the driver paths' batches: each vs plain on its
    own counter, a second launch bitwise equal, CUDA events and device
    time (each kernel of the launch), the bound."""
    import torch
    rec = {}
    cases = [(label, shape, kind) for label, shape in NF_SHAPES
             for kind in ("fwd", "bwd", "bwd_params")]
    for dname in ("bfloat16", "float32"):
        more = NF_F32_DRIVER if dname == "float32" else ()
        for label, shape, kind in cases + [(lb, sh, k) for lb, sh, ks in more
                                           for k in ks]:
            if kind == "bwd_params" and shape["B"] == 1024:
                shape = dict(shape, B=NF_KP_B)
            kern, got, err, text, ok, mask, plain = nf_vs_plain(
                label, shape, dname, kind)
            del got
            require(ok, f"wide_nf {label} {kind} {dname} disagrees with "
                    f"plain: {text}")
            t_plain = cuda_time_ms(plain, reps=3, calls=1, warmup=1)
            torch.cuda.empty_cache()
            ms = cuda_time_ms(kern, reps=5, calls=3)
            each = device_ms_each(kern, nf_keys(dname, kind))
            fl_f, fl_b, by_f, by_b = work(shape, dname, mask)
            fl, by = {"fwd": (fl_f, by_f), "bwd": (fl_b, by_b),
                      "bwd_params": work_params(shape, dname, mask)}[kind]
            b = bound(fl, by, PEAK_FLOPS[dname])
            keys = nf_keys(dname, kind)
            phase("wide_nf", f"(a) {label} {kind} {dname} B={shape['B']} "
                  f"N={shape['N']} nf={shape['nf']} H={shape['H']}: {text} "
                  f"-> ok; time ms events {ms:.4f} device {sum(each):.4f} ("
                  + ", ".join(f"{k.replace('egcl_', '')} {t:.4f}"
                              for k, t in zip(keys, each))
                  + f"), plain {t_plain:.4f}, bound {b[0]:.4f} ({b[1]}, "
                  f"{fl / 1e9:.2f} GFLOP, {by / 1e6:.2f} MB) on {card}")
            rec[(label, dname, kind)] = dict(err=err, ms=ms, dev=sum(each),
                                             each=each, plain=t_plain,
                                             bound=b)
            del kern, plain
            torch.cuda.empty_cache()
    return rec


def nf_seam(card):
    """(b): at H = 128 and 256, N=13, B=64, per dtype and direction, the
    largest nf that the parent's routes take (the libraries' byte
    functions, through the wrapper's route rule) beside the Python
    mirror's (tests/egcl_smem_mirror.py); at that nf the parent's route and
    the wide-nf route side by side (device times, how far apart their
    outputs are, each vs plain), at nf + 1 the wide-nf route through the
    entry point."""
    import torch
    from enflow_tpu_torch.ops import egcl_allpairs as ops
    sys.path.insert(0, str(ROOT / "tests"))
    import egcl_smem_mirror as mirror
    out = {}
    for dname in ("bfloat16", "float32"):
        code = 1 if dname == "bfloat16" else 0
        for H in (128, 256):
            for kind in ("fwd", "bwd", "bwd_params"):
                nf = 1
                while (ops.route_of(code, (NF_SEAM["B"], NF_SEAM["N"],
                                           nf + 1, H), kind)
                       != ops.WIDE_NF_ROUTE[code]):
                    nf += 1
                mir = mirror.seam_nf(code, NF_SEAM["N"], H, kind)
                require(mir == nf, f"seam {dname} H={H} {kind}: library "
                        f"{nf}, mirror {mir}")
                route = ops.route_of(code, (NF_SEAM["B"], NF_SEAM["N"], nf,
                                            H), kind)
                shape = dict(NF_SEAM, nf=nf, H=H)
                # the parent's route and the forced wide-nf route at nf
                parent = _seam_launch(shape, dname, kind, "parent")
                wide = _seam_launch(shape, dname, kind, "wide_nf")
                apart = max(float((a.float() - b.float()).abs().max())
                            for a, b in zip(parent["got"], wide["got"]))
                kern, got, err, text, ok, _, _ = nf_vs_plain(
                    "seam+1", dict(shape, nf=nf + 1), dname, kind, seed=67)
                require(parent["ok"] and wide["ok"] and ok,
                        f"seam {dname} H={H} {kind}: parent {parent['text']}"
                        f" | wide_nf {wide['text']} | nf+1 {text}")
                t1 = cuda_time_ms(kern, reps=5, calls=3)
                phase("wide_nf", f"(b) seam {dname} H={H} {kind} N=13 B=64: "
                      f"largest nf of the parent's route {nf} (library; "
                      f"mirror {mir}), route {route}: events "
                      f"{parent['ms']:.4f} ms; wide_nf at nf={nf}: "
                      f"{wide['ms']:.4f} ms ({wide['ms'] / parent['ms']:.2f}"
                      f"x); outputs apart by {apart:.2e} (parent vs plain: "
                      f"{parent['text']}; wide_nf vs plain: {wide['text']}); "
                      f"nf={nf + 1} on wide_nf {t1:.4f} ms, vs plain {text}"
                      f" on {card}")
                out[(dname, H, kind)] = dict(nf=nf, parent=parent["ms"],
                                             wide=wide["ms"], apart=apart)
                del kern, got
                torch.cuda.empty_cache()
    return out


def _seam_launch(shape, dname, kind, route):
    """One launch at ``shape`` on the route rule's route (``route`` None)
    or the forced wide-nf route: outputs, reading vs plain, events time."""
    kern, got, err, text, ok, _, _ = nf_vs_plain("seam", shape, dname, kind,
                                                 seed=67, route=route)
    return dict(got=got, text=text, ok=ok,
                ms=cuda_time_ms(kern, reps=5, calls=3))


def nf_runs(main, runs, label, want):
    """``runs`` SMC runs of ``main`` (the first a warm-up), each held to the
    launch counts ``want`` and 0 plain calls; returns (the last result,
    seconds of each run)."""
    import torch
    secs = []
    for _ in range(runs):
        reset_counts()
        res, t = timed_sample(main)
        torch.cuda.synchronize()
        got, plain = launched(), plain_calls()
        require(got == want and plain == 0, f"{label}: launches {got} != "
                f"{want}, plain {plain}")
        secs.append(t)
    return res, secs


def lj13_smc(card, tmp, ph, what, hidden, node, rt, dev_fwd, dev_bwd):
    """The LJ13 flow-SMC at bench.py's settings (SMC_YAML: 1024 particles,
    8 temps, 1 HMC sweep of 5 leapfrog steps, 5 flow steps, bf16) at
    ``hidden`` / ``node`` (``what`` in the lines), run in ``tmp`` twice
    (the first a warm-up): every launch on the counters of route suffix
    ``rt``, 0 plain calls, beta 1, finite log_Z, outputs on the card; the
    kernels' share from K1's and K2's device ms ``dev_fwd`` / ``dev_bwd``
    at B=1024. Prints phase ``ph``'s line; returns the seconds of the
    second run and the launches."""
    import torch
    from enflow_tpu_torch.sample.smc import ess_from_log_weights
    n_iter, n_vg = 5, 1 + 8 * 1 * 5
    main = smc_driver(tmp, hidden=hidden, node=node)
    fwd, bwd = f"fwd{rt}_launches", f"bwd{rt}_launches"
    want = {fwd: n_iter + n_vg * n_iter, bwd: n_vg * n_iter}
    res, secs = nf_runs(main, 2, f"LJ13 SMC {what}", want)
    check_smc(res, f"LJ13 SMC {what}", 1024, 13)
    require(res.log_Z.is_cuda and res.particles["pos"].is_cuda,
            f"LJ13 SMC {what}: outputs are not on the card")
    k = (want[fwd] * dev_fwd + want[bwd] * dev_bwd) / 1e3
    phase(ph, f"(c) LJ13 flow-SMC (bench.py's settings) at {what}, bf16 "
          f"on {card}: {secs[-1]:.3f} s a run (runs "
          + ", ".join(f"{t:.3f}" for t in secs)
          + f" s, first is warm-up), {1024 / secs[-1]:.1f} samples/s, "
          f"log_Z {float(res.log_Z):.4f}, final ESS "
          f"{float(ess_from_log_weights(res.log_weights)):.1f}, beta "
          f"{float(res.beta_history[-1]):.6f}; launches {want}, plain calls "
          f"0; kernels (launches x device time at B=1024) {k:.3f} s "
          f"({k / secs[-1]:.1%})")
    del main, res
    torch.cuda.empty_cache()
    return dict(secs=secs[-1], launches=want)


def vi_then_sample(card, tmp, ph, what, dname, config, steps, dyn, rt,
                   dev_step, sample=None):
    """``config`` (a VI config, ``what`` in the lines) 1 x ``steps`` in
    the working directory ``tmp`` with the ``dynamics`` keys ``dyn`` and a
    checkpoint: every launch on the counters of route suffix ``rt`` (K1 +
    K2 p a flow step), 0 plain calls, finite losses; then, where ``sample``
    = (sampler config, its ``sampling`` keys, N, K2's device ms or None)
    is given, that sampler from the checkpoint: K1 + K2 on the same
    counters, beta 1, finite log_Z, outputs on the card. ``dev_step``: K1
    + K2 p device ms at the VI's shape (the kernels' share). Prints phase
    ``ph``'s lines; returns {"vi": ..., "smc": ...} (seconds, launches,
    particles)."""
    import torch
    ckpt = f"{ph}_{dname}.cpt"
    net = dict(dyn, checkpoint_path=ckpt)
    vi = config_driver(tmp, config, over=dict(
        num_epochs=1, steps_per_epoch=steps), dynamics=net)
    ni, P = vi.n_iter, vi.vi_particles
    require(vi.hidden_nf == dyn["network"]["hidden_nf"],
            f"{what}: hidden_nf {vi.hidden_nf}")
    step_s, losses = time_vi_steps(vi)
    reset_counts()
    vi.train()
    torch.cuda.synchronize()
    got, plain = launched(), plain_calls()
    want = {f"fwd{rt}_launches": ni * steps,
            f"bwd_param{rt}_launches": ni * steps}
    require(len(step_s) == steps and got == want and plain == 0,
            f"{what} in {dname}: {len(step_s)} steps, launches {got} != "
            f"{want}, plain {plain}")
    require(all(math.isfinite(x) for x in losses),
            f"non-finite {what} losses {losses}")
    require(Path(ckpt).exists(), f"{what} in {dname}: no checkpoint")
    s_step = statistics.median(step_s[1:])
    k = ni * dev_step / 1e3
    out = dict(vi=dict(s_step=s_step, launches=got, P=P))
    phase(ph, f"(c) {what} in {dname} on {card}: 1 epoch x {steps} steps "
          f"of {P} particles, {s_step:.5f} s/step (median of steps "
          f"2-{steps}; first {step_s[0]:.4f} s); losses "
          + ", ".join(f"{x:.2f}" for x in losses)
          + f"; launches {got}, plain calls 0; kernels ({ni} x (K1 + K2 p) "
          f"device time) {k:.5f} s ({k / s_step:.1%})")
    del vi
    if sample is None:
        return out
    config, over, N, dev_bwd = sample
    smc = config_driver(tmp, config, over=dict(
        over, output=f"{ph}_{dname}.npz"), dynamics=net)
    sec = smc.args["sampling"]
    P = sec["n_particles"]
    n_vg = 1 + sec["n_temps"] * sec["mcmc_steps"] * sec["n_leapfrog"]
    want = {f"fwd{rt}_launches": ni + n_vg * ni,
            f"bwd{rt}_launches": n_vg * ni}
    label = f"{config} from {what} in {dname}"
    res, secs = nf_runs(smc, 1, label, want)
    check_smc(res, label, P, N)
    pos = res.particles["pos"]
    require(pos.is_cuda and res.log_Z.is_cuda
            and (pos.dtype == torch.float32 or dname != "float32"),
            f"{label}: outputs not on the card")
    share = ""
    if dev_bwd is not None:
        k = want[f"bwd{rt}_launches"] * dev_bwd / 1e3
        share = f"; K2 (launches x device time) {k:.3f} s " \
            f"({k / secs[-1]:.1%})"
    phase(ph, f"(c) {config} in {dname} from that checkpoint on {card}: "
          f"{P} particles x {sec['n_temps']} temps, {secs[-1]:.3f} s (the "
          f"first run, builds warm), log_Z {float(res.log_Z):.4f}, beta "
          f"{float(res.beta_history[-1]):.6f}; launches {want} ({n_vg} "
          f"value-and-grads), plain calls 0" + share)
    out["smc"] = dict(secs=secs[-1], launches=want, P=P)
    del smc, res, pos
    torch.cuda.empty_cache()
    return out


def nf_paths(card, rec):
    """(c): LJ13 flow-SMC at bench.py's settings (SMC_YAML: 1024
    particles, 8 temps, 1 HMC sweep of 5 leapfrog steps, 5 flow steps,
    bf16) at node_nf 128 (H 128) and at node_nf 256, hidden_nf 256;
    ``vi_lj13.yaml`` at node_nf 128 1 x NF_VI_STEPS (K2 p); the same VI in
    float32, then a float32 ``sample_lj13.yaml`` of NF_SMC from its
    checkpoint. Every launch on the wide-nf counters, 0 plain calls, beta
    1, finite log_Z and losses, outputs on the card; seconds a run or step
    and the kernels' share (launches x device time at (a)'s shapes)."""
    import os

    cwd = os.getcwd()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        try:
            for node, hidden, key in ((128, 128, "ref128"),
                                      (256, 256, "ref256")):
                out[f"smc{node}"] = lj13_smc(
                    card, tmp, "wide_nf", f"node_nf {node}, hidden_nf "
                    f"{hidden}", hidden, node, "_wide_nf",
                    rec[(key, "bfloat16", "fwd")]["dev"],
                    rec[(key, "bfloat16", "bwd")]["dev"])
            for dname, dyn in (("bfloat16", {}),
                               ("float32", dict(compute_dtype="float32"))):
                f32 = dname == "float32"
                r = vi_then_sample(
                    card, tmp, "wide_nf", "vi_lj13.yaml at node_nf 128",
                    dname, "vi_lj13.yaml", NF_VI_STEPS,
                    dict(dyn, network=dict(hidden_nf=128, node_nf=128)),
                    "_f32_wide_nf" if f32 else "_wide_nf",
                    rec[("vi512" if f32 else "ref128", dname, "fwd")]["dev"]
                    + rec[("ref128", dname, "bwd_params")]["dev"],
                    ("sample_lj13.yaml", NF_SMC, 13,
                     rec[("smc256", dname, "bwd")]["dev"]) if f32 else None)
                out[f"vi_{dname}"] = r["vi"]
                if f32:
                    out["smc_f32"] = r["smc"]
        finally:
            os.chdir(cwd)
    return out


def wide_nf_phase(card):
    """Phase wide_nf: (a) ``nf_kernels``, (b) ``nf_seam``, (c)
    ``nf_paths``. Returns the records and the paths' launches."""
    rec = nf_kernels(card)
    seam = nf_seam(card)
    paths = nf_paths(card, rec)
    return dict(rec=rec, seam=seam, paths=paths)

# ---------------------------------------------------------------------------
# phase xwide: the all-pairs EGCL past H = 256 (routes "xwide", bf16 on
# wgmma, and "f32_xwide", float32 on the FMA units; both in
# csrc/egcl_allpairs_xwide.cu). (a) K1, K2 and K2 p at each H of XWIDE_HS
# and N of XWIDE_NS in both dtypes against the plain version (at
# XWIDE_CHECK_B molecules, where the plain version's [B, N, N, H] tensors
# fit at H = 1024), each launch on its route's counter, a second launch
# bitwise equal; the seam at H = 256 (the xwide kernels beside the route
# of 256); (b) each kernel at the reference's shapes (XWIDE_TIMED) timed
# with CUDA events and as device time beside its bound and the plain
# version; (c) the driver paths at hidden_nf XWIDE_H: the LJ13 flow-SMC at
# bench.py's settings (bf16, B=1024), vi_lj13.yaml (K2 p at B=512) and
# sample_lj13.yaml from its checkpoint cut to XWIDE_SMC13, vi_ala2.yaml in
# float32 (B=256, N=22, nf=4) and sample_ala2.yaml from its checkpoint cut
# to XWIDE_ALA2 temperatures (B=2048).
XWIDE_HS = (300, 320, 384, 512, 1024)
XWIDE_NS = (13, 55, 147)
XWIDE_CHECK_B = {13: 16, 55: 4, 147: 2}
XWIDE_H = 512
XWIDE_VI_STEPS = 3
XWIDE_SMC13 = dict(n_particles=1024, n_temps=4)
XWIDE_ALA2 = dict(n_temps=2)
XWIDE_TIMED = {
    "bfloat16": (("ref512", dict(B=1024, N=13, nf=5, H=XWIDE_H),
                  ("fwd", "bwd")),
                 ("vi512", dict(B=512, N=13, nf=5, H=XWIDE_H),
                  ("fwd", "bwd_params")),
                 ("lj55", dict(B=256, N=55, nf=5, H=XWIDE_H),
                  ("fwd", "bwd", "bwd_params"))),
    "float32": (("ref512", dict(B=1024, N=13, nf=5, H=XWIDE_H),
                 ("fwd", "bwd")),
                ("vi_ala2", dict(B=256, N=22, nf=4, H=XWIDE_H),
                 ("fwd", "bwd_params")),
                ("sample_ala2", dict(B=2048, N=22, nf=4, H=XWIDE_H),
                 ("fwd", "bwd")),
                ("lj55", dict(B=64, N=55, nf=5, H=XWIDE_H),
                 ("fwd", "bwd", "bwd_params")))}


@contextlib.contextmanager
def f64_sums():
    """The all-pairs plain version with every product and sum accumulated
    in float64, its compute-dtype roundings where they are."""
    import torch
    from enflow_tpu_torch.ops import egcl_allpairs as ops
    acc = ops._acc
    ops._acc = lambda dt: torch.float64
    try:
        yield
    finally:
        ops._acc = acc


def plain_f64_twin(args, terms=False):
    """The nine parameter gradients of ``allpairs_edges_plain_bwd`` at
    ``args`` under ``f64_sums`` (with ``terms``: the sums of their terms'
    magnitudes, ``"l2"``: the root of the sum of their squares), summed
    over batches of molecules that keep each [b, N, N, H] tensor under
    2^26 elements; float32."""
    from enflow_tpu_torch.ops import egcl_allpairs as ops
    h, pos, box, mf, W, dagg, dfsum = args
    B, N = h.shape[:2]
    H = W[4].shape[1]
    chunk = max(1, 2 ** 26 // (N * N * H))
    tot = None
    with f64_sums():
        for b0 in range(0, B, chunk):
            s = slice(b0, b0 + chunk)
            g = ops.allpairs_edges_plain_bwd(
                h[s], pos[s], box[s], mf[s], W, dagg[s], dfsum[s],
                params=True, terms=terms)[2:]
            if terms == "l2":
                g = [t.square() for t in g]
            tot = list(g) if tot is None else [a + b for a, b in zip(tot, g)]
    if terms == "l2":
        tot = [t.sqrt() for t in tot]
    return [t.float() for t in tot]


def twin_reading(got, want, args):
    """(ok, text, readings) of the bf16 parameter gradients past H = 256:
    the kernel's and the plain version's against ``plain_f64_twin``, each
    within the parameter bound widened by FLIP_TOL x the root-sum-square
    of the gradient's terms (the plain version too: a limit that a sound
    implementation breaks is no limit); ``readings``: {gradient: the
    kernel's}."""
    names = PARAM_OUT[2:]
    twin = plain_f64_twin(args)
    terms = dict(zip(names, plain_f64_twin(args, terms=True)))
    flips = dict(zip(names, plain_f64_twin(args, terms="l2")))
    rk = step_errs(names, got[2:], twin, terms, flips=flips)
    rp = step_errs(names, want[2:], twin, terms, flips=flips)
    readings = {n: rk[n][1] for n in names}
    return steps_ok(rk) and steps_ok(rp), \
        "vs the f64-summed twin " + "  ".join(
            f"{n} {rk[n][1]:.2f}x (plain {rp[n][1]:.2f}x)" for n in names), \
        readings


def xwide_keys(kind):
    """The kernels of one xwide launch (substrings of their names): the
    projections, the tile kernel, and for the backward the j-side sums, dh
    and (K2 p) dW1's splits."""
    keys = ("egcl_nf_proj", "egcl_xwide_kernel")
    if kind != "fwd":
        keys += ("egcl_nf_jsum", "egcl_nf_dh")
    if kind == "bwd_params":
        keys += ("egcl_nf_dw1",)
    return keys


def xwide_vs_plain(label, shape, dname, kind, seed=71, forced=False,
                   sliced=False):
    """One launch of ``kind`` at ``shape`` against the plain version: bf16
    read per element (``step_errs``), f32 against TOL / TOL_PARAM; a second
    launch must give the same bits. Through the entry point, on the xwide
    counter of the dtype alone (and ``padded_launches`` at a padded width);
    ``forced``: the xwide kernels through ``allpairs_edges_xwide``;
    ``sliced``: every batch-shaped input a slice of one molecule more from
    its second on, so that h, pos, box and the mask do not start on 16
    bytes (the launch reads copies of them). Returns (the launch, max abs
    err, reading text, ok, the mask, the plain call)."""
    import torch
    from enflow_tpu_torch.ops import egcl_allpairs as ops
    dt = getattr(torch, dname)
    if sliced:
        shape = dict(shape, B=shape["B"] + 1)
    h, pos, box, mf, W, dagg, dfsum, mask = edge_inputs(shape, dt, seed)
    if sliced:
        h, pos, box, mf, dagg, dfsum, mask = (
            t[1:] for t in (h, pos, box, mf, dagg, dfsum, mask))
        require(all(t.data_ptr() % 16 for t in (h, pos, box, mf)),
                f"xwide {label}: a sliced input starts on 16 bytes")
    args = (h, pos, box, mf, W, dagg, dfsum)
    ins = args[:5] if kind == "fwd" else args
    if forced:
        kern = lambda: ops.allpairs_edges_xwide(kind, *ins)
    elif kind == "fwd":
        kern = lambda: ops.allpairs_edges_fwd(*ins)
    else:
        kern = lambda: ops.allpairs_edges_bwd(*ins,
                                              params=kind == "bwd_params")
    plain = ((lambda: ops.allpairs_edges_plain(*ins)) if kind == "fwd" else
             (lambda: ops.allpairs_edges_plain_bwd(
                 *ins, params=kind == "bwd_params")))
    code = 1 if dname == "bfloat16" else 0
    ops.counts.reset()
    got = kern()
    torch.cuda.synchronize()
    want_c = {launch_counter(kind, ops.XWIDE_ROUTE[code]): 1}
    if ops.padded_width(shape["H"]) != shape["H"]:
        want_c["padded_launches"] = 1
    require(launched() == want_c, f"xwide {label} {kind} {dname}: "
            f"launches {launched()} != {want_c}")
    want = plain()
    ok, text, err = xwide_reading(got, want, args, dname, kind)
    same = all(bool(torch.equal(a, b)) for a, b in zip(got, kern()))
    del want, got
    return kern, err, f"{text}; a second launch gives the same bits: " \
        f"{same}", ok and same, mask, plain


def xwide_reading(got, want, args, dname, kind):
    """(ok, text, max abs err) of one launch against the plain version:
    bf16 per element (``step_errs``; past H = 256 the parameter gradients
    against the f64-summed twin, ``twin_reading``), f32 against TOL /
    TOL_PARAM."""
    H = args[4][4].shape[1]
    names = (("agg", "f_sum") if kind == "fwd" else PARAM_OUT
             if kind == "bwd_params" else ("dh", "dpos"))
    if dname == "bfloat16":
        params = kind == "bwd_params"
        errs = step_errs(names, got, want, plain_terms(args)
                         if params else None)
        text = steps_text(errs)
        err = max(a for a, _, _ in errs.values())
        if params and H > 256:
            outs = {n: errs[n] for n in ("dh", "dpos")}
            ok, twin, _ = twin_reading(got, want, args)
            return ok and steps_ok(outs), f"{text}; {twin}", err
        return steps_ok(errs), text, err
    errs = rel_errs(names, got, want)
    ok = all(r <= (TOL_PARAM if n in PARAM_OUT[2:] else TOL)[dname]
             for n, (_, r) in errs.items())
    text = "  ".join(f"{n} {a:.2e}/{r:.1e}" for n, (a, r) in errs.items())
    return ok, text, max(a for a, _ in errs.values())


def xwide_checks(card):
    """(a): the library's shared memory and threads a block at several H
    beside the Python mirror (tests/egcl_smem_mirror.py); every H of
    XWIDE_HS x N of XWIDE_NS x direction in both dtypes against the plain
    version; then the seam at H = 256 (N=13, B=64): the route of 256 and
    the xwide kernels forced, side by side."""
    import torch
    from enflow_tpu_torch.ops import egcl_allpairs as ops
    sys.path.insert(0, str(ROOT / "tests"))
    import egcl_smem_mirror as mirror
    lib = ops._xwide_library()
    for code in (1, 0):
        for kind, kname in enumerate(("K1", "K2", "K2 p")):
            got = {H: lib.egcl_xwide_smem_bytes(code, H, kind)
                   for H in (320, 512, 1024, ops.XWIDE_MAX_H)}
            want = {H: mirror.xwide_bytes(code, H, kind) for H in got}
            tiles = lib.egcl_xwide_tiles(code, kind)
            require(got == want and len(set(got.values())) == 1
                    and tiles == mirror.xwide_tiles(code, kind),
                    f"xwide shared memory (code {code}, {kname}): library "
                    f"{got}, mirror {want}; tiles {tiles}")
            phase("xwide", f"(a) {'bf16' if code else 'float32'} {kname}: "
                  f"{lib.egcl_xwide_threads(code, kind)} threads, "
                  f"{got[512]:,} bytes of shared memory a block at every H "
                  f"of 320, 512, 1024 and {ops.XWIDE_MAX_H} (the mirror's "
                  f"too), of {ops.SMEM_LIMIT:,}; {tiles} [64, H] scratch "
                  "tiles a block")
        require(lib.egcl_xwide_max_width() == ops.XWIDE_MAX_H,
                f"xwide widest H {lib.egcl_xwide_max_width()}")
    n = 0
    for dname in ("bfloat16", "float32"):
        for H in XWIDE_HS:
            for N in XWIDE_NS:
                shape = dict(B=XWIDE_CHECK_B[N], N=N, nf=5, H=H, n_pad=1)
                texts = []
                for kind in ("fwd", "bwd", "bwd_params"):
                    kern, err, text, ok, _, _ = xwide_vs_plain(
                        f"H={H} N={N}", shape, dname, kind)
                    require(ok, f"xwide H={H} N={N} {kind} {dname} "
                            f"disagrees with plain: {text}")
                    texts.append(f"{kind}: {text}")
                    n += 1
                    del kern
                phase("xwide", f"(a) {dname} H={H} (at "
                      f"{ops.padded_width(H)}) N={N} B={shape['B']}: "
                      + " | ".join(texts) + " -> ok")
                torch.cuda.empty_cache()
        # inputs that do not start on 16 bytes: the launch's copies of
        # them must live until the kernels have read them
        shape = dict(B=16, N=13, nf=5, H=320, n_pad=1)
        texts = []
        for kind in ("fwd", "bwd", "bwd_params"):
            kern, _, text, ok, _, _ = xwide_vs_plain(
                "sliced", shape, dname, kind, sliced=True)
            require(ok, f"xwide sliced inputs {kind} {dname} disagrees "
                    f"with plain: {text}")
            texts.append(f"{kind}: {text}")
            n += 1
            del kern
        phase("xwide", f"(a) {dname} H=320 N=13 B=16, h, pos, box and the "
              "mask batch slices off 16 bytes: " + " | ".join(texts)
              + " -> ok")
    seam = {}
    for dname in ("bfloat16", "float32"):
        for kind in ("fwd", "bwd", "bwd_params"):
            shape = dict(B=64, N=13, nf=5, H=256)
            k0, t0, ok0 = _route_launch(shape, dname, kind)
            k1, _, t1, ok1, _, _ = xwide_vs_plain("seam", shape, dname, kind,
                                                  forced=True)
            require(ok0 and ok1, f"seam {dname} {kind}: route of 256 {t0} | "
                    f"xwide {t1}")
            ms0 = cuda_time_ms(k0, reps=5, calls=3)
            ms1 = cuda_time_ms(k1, reps=5, calls=3)
            seam[(dname, kind)] = (ms0, ms1)
            phase("xwide", f"(a) seam {dname} {kind} H=256 N=13 B=64 on "
                  f"{card}: route of 256 {ms0:.4f} ms, xwide forced "
                  f"{ms1:.4f} ms ({ms1 / ms0:.2f}x); route of 256 vs plain "
                  f"{t0}; xwide vs plain {t1}")
            del k0, k1
            torch.cuda.empty_cache()
    return n, seam


def _route_launch(shape, dname, kind):
    """One launch at ``shape`` through the entry point on whatever route
    the rule names (H <= 256 here), against the plain version. Returns
    (the launch, reading text, ok)."""
    import torch
    from enflow_tpu_torch.ops import egcl_allpairs as ops
    dt = getattr(torch, dname)
    h, pos, box, mf, W, dagg, dfsum, _ = edge_inputs(shape, dt, 71)
    args = (h, pos, box, mf, W, dagg, dfsum)
    if kind == "fwd":
        kern = lambda: ops.allpairs_edges_fwd(*args[:5])
        want = ops.allpairs_edges_plain(*args[:5])
    else:
        p = kind == "bwd_params"
        kern = lambda: ops.allpairs_edges_bwd(*args, params=p)
        want = ops.allpairs_edges_plain_bwd(*args, params=p)
    ok, text, _ = xwide_reading(kern(), want, args, dname, kind)
    return kern, text, ok


def xwide_kernels(card):
    """(b): each kernel at XWIDE_TIMED's shapes: against the plain version
    (as in (a)), CUDA events and device time (each kernel of the launch),
    the plain version's time, the bound. Returns {(label, dname, kind):
    record}."""
    import torch
    rec = {}
    for dname, cases in XWIDE_TIMED.items():
        for label, shape, kinds in cases:
            for kind in kinds:
                kern, err, text, ok, mask, plain = xwide_vs_plain(
                    label, shape, dname, kind, seed=73)
                require(ok, f"xwide {label} {kind} {dname} disagrees with "
                        f"plain: {text}")
                t_plain = cuda_time_ms(plain, reps=3, calls=1, warmup=1)
                torch.cuda.empty_cache()
                ms = cuda_time_ms(kern, reps=5, calls=3)
                keys = xwide_keys(kind)
                each = device_ms_each(kern, keys, calls=10)
                fl_f, fl_b, by_f, by_b = work(shape, dname, mask)
                fl, by = {"fwd": (fl_f, by_f), "bwd": (fl_b, by_b),
                          "bwd_params": work_params(shape, dname, mask)}[kind]
                b = bound(fl, by, PEAK_FLOPS[dname])
                phase("xwide", f"(b) {label} {kind} {dname} B={shape['B']} "
                      f"N={shape['N']} nf={shape['nf']} H={shape['H']}: "
                      f"{text} -> ok; time ms events {ms:.4f} device "
                      f"{sum(each):.4f} ("
                      + ", ".join(f"{k.replace('egcl_', '')} {t:.4f}"
                                  for k, t in zip(keys, each))
                      + f"), plain {t_plain:.4f}, bound {b[0]:.4f} ({b[1]}, "
                      f"{fl / 1e9:.2f} GFLOP, {by / 1e6:.2f} MB), "
                      f"{fl / (sum(each) * 1e9):.2f} TFLOP/s on {card}")
                rec[(label, dname, kind)] = dict(err=err, ms=ms,
                                                 dev=sum(each), each=each,
                                                 plain=t_plain, bound=b)
                del kern, plain
                torch.cuda.empty_cache()
    return rec


def xwide_paths(card, rec):
    """(c): the driver paths at hidden_nf XWIDE_H, every launch on the
    xwide counters of the dtype (none elsewhere), 0 plain calls, beta 1,
    finite log_Z and losses, outputs on the card; seconds and the kernels'
    share (launches x device time at (b)'s shapes)."""
    import os

    cwd = os.getcwd()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        try:
            out["smc"] = lj13_smc(
                card, tmp, "xwide", f"hidden_nf {XWIDE_H}", XWIDE_H, 5,
                "_xwide", rec[("ref512", "bfloat16", "fwd")]["dev"],
                rec[("ref512", "bfloat16", "bwd")]["dev"])
            for dname, config, sample, N, over, dyn in (
                    ("bfloat16", "vi_lj13.yaml", "sample_lj13.yaml", 13,
                     XWIDE_SMC13, dict(network=dict(hidden_nf=XWIDE_H,
                                                    node_nf=5))),
                    ("float32", "vi_ala2.yaml", "sample_ala2.yaml", 22,
                     XWIDE_ALA2, dict(network=dict(hidden_nf=XWIDE_H,
                                                   node_nf=4)))):
                f32 = dname == "float32"
                key = "vi_ala2" if f32 else "vi512"
                r = vi_then_sample(
                    card, tmp, "xwide", f"{config} at hidden_nf {XWIDE_H}",
                    dname, config, FF_STEPS if f32 else XWIDE_VI_STEPS, dyn,
                    "_f32_xwide" if f32 else "_xwide",
                    rec[(key, dname, "fwd")]["dev"]
                    + rec[(key, dname, "bwd_params")]["dev"],
                    (sample, over, N, None))
                out[f"vi_{dname}"] = r["vi"]
                out[f"smc_{dname}"] = r["smc"]
        finally:
            os.chdir(cwd)
    return out


# What each part of the bf16 ring kernels (K1 / K2 past H = 256) costs:
# builds of csrc/ with one part removed, {name: {source: [(text, its
# replacement)]}}. Their values are wrong; only their times are read.
XWIDE_ABLATE = {
    "no epilogues": {"xwide_engine.cuh": [
        ("        epi(o, d, std::integral_constant<int, 16>{});", ""),
        ("        epi(o, d, std::integral_constant<int, 8>{});", "")]},
    "no products": {"xwide_engine.cuh": [
        ("      mma<MODE, WIDE>(d, st + (2 + c) * kBox, st, k > 0);", "")]},
    "no m1 pass": {"egcl_allpairs_xwide.cu": [
        ("      if (act) ring_m1<BWD>(a, R, X[3], X[4], t);\n", "")]},
    "no paired rounding": {"egcl_allpairs_xwide.cu": [
        ("  return __bfloat1622float2(to_bf2(x, y));",
         "  return make_float2(x, y);")]},
    "a linear sigmoid": {"sm90_common.cuh": [
        ("  return __fdividef(1.0f, 1.0f + __expf(-x));",
         "  return 0.5f + 0.25f * x;")]}}


def xwide_ablate_phase(card, rounds=2):
    """The bf16 K1 / K2 at the reference's B=1024, N=13, H=512 (device
    time) with the library as built and with each XWIDE_ABLATE build
    (copies of csrc/ with one part removed, built in parallel), in turns
    within this process, ``rounds`` times; prints each build's times and
    what removing its part saved."""
    import ctypes
    import shutil
    import torch
    from enflow_tpu_torch.ops import build
    from enflow_tpu_torch.ops import egcl_allpairs as ops

    full = ops._xwide_library()
    tmp = Path(tempfile.mkdtemp())
    procs = {}
    for name, edits in XWIDE_ABLATE.items():
        src = tmp / name.replace(" ", "_")
        shutil.copytree(build.CSRC, src)
        for fname, pairs in edits.items():
            text = (src / fname).read_text()
            for old, new in pairs:
                require(text.count(old) == 1, f"ablation '{name}': its text "
                        f"is not in {fname} once")
                text = text.replace(old, new)
            (src / fname).write_text(text)
        procs[name] = subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-o", str(src / "lib.so"),
             str(src / "egcl_allpairs_xwide.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    libs = {"as built": full}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        require(proc.returncode == 0, f"ablation '{name}' did not build:\n"
                f"{log[-3000:]}")
        lib = ctypes.CDLL(str(tmp / name.replace(" ", "_") / "lib.so"))
        for fn in ("egcl_xwide_fwd", "egcl_xwide_bwd", "egcl_xwide_grid",
                   "egcl_xwide_tiles", "egcl_xwide_error_string",
                   "egcl_part_size"):
            f, g = getattr(lib, fn), getattr(full, fn)
            f.argtypes, f.restype = g.argtypes, g.restype
        lib._enflow_bound = True
        libs[name] = lib
    args = edge_inputs(dict(B=1024, N=13, nf=5, H=XWIDE_H), torch.bfloat16,
                       seed=11)[:7]
    times = {name: [] for name in libs}
    try:
        for _ in range(rounds):
            for name, lib in libs.items():
                build._loaded["egcl_allpairs_xwide"] = lib
                times[name].append((
                    device_ms(lambda: ops.allpairs_edges_fwd(*args[:5]),
                              "egcl_xwide_kernel", calls=5),
                    device_ms(lambda: ops.allpairs_edges_bwd(*args),
                              "egcl_xwide_kernel", calls=5)))
    finally:
        build._loaded["egcl_allpairs_xwide"] = full
        shutil.rmtree(tmp, ignore_errors=True)
    med = {name: [statistics.median(t[k] for t in ts) for k in (0, 1)]
           for name, ts in times.items()}
    base = med["as built"]
    for name, (k1, k2) in med.items():
        phase("xwide_ablate", f"{name} on {card}: K1 {k1:.4f} ms, K2 "
              f"{k2:.4f} ms device (B=1024, N=13, H={XWIDE_H}, medians of "
              f"{rounds} turns)" + ("" if name == "as built" else
                                    f"; removing it saves K1 "
                                    f"{base[0] - k1:.4f}, K2 "
                                    f"{base[1] - k2:.4f} ms"))


def xwide_phase(card):
    """Phase xwide: (a) ``xwide_checks``, (b) ``xwide_kernels``, (c)
    ``xwide_paths``. Returns the records and the paths' launches."""
    n, seam = xwide_checks(card)
    rec = xwide_kernels(card)
    paths = xwide_paths(card, rec)
    return dict(n=n, seam=seam, rec=rec, paths=paths)


def fluid_phase(card):
    """``example/vi_fluid.yaml``: the periodic LJ fluid (N=32, box 6.5,
    H=64, bf16) with the learned drift, a kick and a drift EGCL a flow
    step; then K1 and K2 p at B=256, N=32, H=64 with pairs on both sides
    of the half box and one pair exactly on it."""
    def check(main):
        soft, cap, beta = main.vi_schedule(0)
        require(main.vi_box == 6.5 and abs(soft - 0.2) < 1e-12
                and main.flow_cfg.position_update == "drift",
                f"vi_fluid: box {main.vi_box}, epoch-0 softening {soft}, "
                f"position_update {main.flow_cfg.position_update}")
    return vi_config_phase(card, "fluid", "vi_fluid.yaml", FLUID_STEPS,
                           2 * 5, dict(B=256, N=32, nf=5, H=64, box=6.5,
                                       half=True), "bfloat16", check)


# flow-SMC on DW4 from vi_dw4.yaml's checkpoint, float32: the f32 sampler
# path, whose HMC gradients run the tiled f32 input-gradient K2
DW4_SMC = dict(algo="smc", n_particles=512, n_temps=8, mcmc_steps=1,
               step_size=0.02, n_leapfrog=5, output="dw4_samples.npz",
               target=dict(type="double_well", n_atoms=4, kBT=1.0))


def dw4_smc(card, vi):
    """``mode: sample`` (DW4_SMC) from the checkpoint ``vi`` wrote, in its
    working directory: float32 K1 and the tiled f32 input-gradient K2 at
    B=512, N=4, nf=2, H=64, with the launches the code implies and no
    plain call."""
    import yaml
    from enflow_tpu_torch.ops import egcl_allpairs as ops
    from enflow_tpu_torch.train.driver import Main

    cfg = dict(mode="sample", units=dict(time="pico", dist="ang"),
               precision="float32", seed=0,
               dynamics=dict(checkpoint_path=vi.checkpoint_path,
                             nbr_mode="all_pairs"), sampling=DW4_SMC)
    Path("sample_dw4.yaml").write_text(yaml.safe_dump(cfg))
    main = Main(device="cuda")
    main.setup("sample_dw4.yaml")
    reset_counts()
    res, secs = timed_sample(main)
    n_iter, P = main.n_iter, DW4_SMC["n_particles"]
    n_vg = 1 + DW4_SMC["n_temps"] * DW4_SMC["mcmc_steps"] \
        * DW4_SMC["n_leapfrog"]
    want = dict(k1=n_iter + n_vg * n_iter, k2=n_vg * n_iter, k2_params=0,
                plain=0)
    got, k2_f32 = vi_launches(), ops.counts.bwd_f32_launches
    require(got == want and k2_f32 == want["k2"],
            f"dw4 SMC launches {got} (tiled f32 K2 {k2_f32}) != {want}")
    check_smc(res, "dw4 SMC", P, 4)
    phase("dw4", f"flow-SMC from the vi_dw4 checkpoint on {card}: {P} "
          f"particles x {DW4_SMC['n_temps']} temps, float32, {secs:.3f} s, "
          f"log_Z {float(res.log_Z):.4f}; launches K1 {got['k1']}, tiled "
          f"f32 K2 {k2_f32} ({n_vg} value-and-grads), plain calls 0")
    return dict(k1=got["k1"], k2=k2_f32, secs=secs)


def dw4_phase(card):
    """``example/vi_dw4.yaml``: DW4 (N=4, nf=2, H=64) in float32, the tiled
    f32 K1 and K2 p of egcl_allpairs_f32.cu; then flow-SMC from its
    checkpoint (``dw4_smc``: the tiled f32 K2); then those three kernels
    against their plain version at B=512, N=4, nf=2, a second launch
    bitwise equal, timed (events and device time)."""
    return vi_config_phase(card, "dw4", "vi_dw4.yaml", DW4_STEPS, 4,
                           DW4, "float32", after=lambda vi: dw4_smc(card, vi),
                           kinds=("fwd", "bwd_params", "bwd"), repeat=True,
                           device=True)


def ala2_kernels():
    """The f32 kernels at alanine dipeptide's size. The tiled f32
    K2 p must take N >= 22 at nf=4, H=128 and the tiled f32 K2 N >= 70 at
    nf=5, H=128, one atom past each largest the f32 block-pair kernels
    (held against plain there; the K2 also at N=70). Then the tiled f32
    K1, K2
    p and K2 against their plain version at vi_ala2.yaml's shape (B=256,
    N=22, nf=4, H=128), the K2 also at sample_ala2.yaml's B=2048 and its
    dh/dpos against K2 p's; a second launch bitwise equal; each timed
    (events and device time) with its bound."""
    import torch
    from enflow_tpu_torch.ops import egcl_allpairs as ops

    lim = {}
    for nf, H in ((5, 128), (5, 64), (4, 128)):
        for kind in ("fwd", "bwd", "bwd_params"):
            lim[(nf, H, kind)] = ops.largest_molecule(0, nf, H, kind)
    phase("ala2", "largest N, f32 tiled: " + ", ".join(
        f"nf={nf} H={H} {kind} {a}" for (nf, H, kind), a in lim.items()))
    for nf, kind, least in ((4, "bwd_params", 22), (5, "bwd", 70)):
        n_max = lim[(nf, 128, kind)]
        require(n_max >= least, f"f32 {kind} takes N <= {n_max} at "
                f"nf={nf}, H=128 (needs {least})")
        shape = dict(B=2, N=n_max + 1, nf=nf, H=128, n_pad=1)
        h, pos, box, mask_f, W, dagg, dfsum, _ = edge_inputs(
            shape, torch.float32, seed=11)
        args = (h, pos, box, mask_f, W, dagg, dfsum)
        params = kind == "bwd_params"
        names = PARAM_OUT if params else ("dh", "dpos")
        ops.counts.reset()
        got = ops.allpairs_edges_bwd(*args, params=params)
        torch.cuda.synchronize()
        launched, other = f32_blocks_launches()
        errs = rel_errs(names, got, ops.allpairs_edges_plain_bwd(
            *args, params=params))
        tol = {n: (TOL_PARAM if n in PARAM_OUT[2:] else TOL)["float32"]
               for n in names}
        same = all(bool(torch.equal(a, b)) for a, b in zip(
            got, ops.allpairs_edges_bwd(*args, params=params)))
        ok = (launched[kind] == 1 and other == 0 and same
              and all(r <= tol[n] for n, (_, r) in errs.items()))
        phase("ala2", f"N={n_max + 1} nf={nf} f32 {kind} (one atom past the "
              f"tiled kernel's {n_max}): the f32 block pairs {launched}, "
              f"others {other}; max rel err {max(r for _, r in errs.values()):.1e}"
              f"; a second launch gives the same bits: {same} -> "
              f"{'ok' if ok else 'FAIL'}")
        require(ok, f"f32 {kind} past the tiled limit: launches {launched} "
                f"+ {other}, errs {errs}, same {same}")
    allpairs_vs_plain("ala2", "N=70", dict(B=4, N=70, nf=5, H=128),
                      "float32", 43, ("bwd",), time_it=False, repeat=True)
    rec = allpairs_vs_plain("ala2", "vi_ala2 shape", ALA2, "float32", 37,
                            ("fwd", "bwd_params", "bwd"), repeat=True,
                            device=True, plain_reps=(5, 2))
    # dh/dpos of the input-gradient K2 against K2 p's on the same inputs
    # (two kernels, two orders of dh's sums: equal to TOL, not bitwise)
    h, pos, box, mask_f, W, dagg, dfsum, _ = edge_inputs(ALA2, torch.float32,
                                                         37)
    args = (h, pos, box, mask_f, W, dagg, dfsum)
    vs = rel_errs(("dh", "dpos"), ops.allpairs_edges_bwd(*args),
                  ops.allpairs_edges_bwd(*args, params=True)[:2])
    phase("ala2", "vi_ala2 shape: K2 dh/dpos vs K2 p's " + "  ".join(
        f"{n} {r:.1e}" for n, (_, r) in vs.items())
          + f" (tol {TOL['float32']:g})")
    require(all(r <= TOL["float32"] for _, r in vs.values()),
            f"the f32 K2 and K2 p disagree on dh/dpos: {vs}")
    rec["bwd_2048"] = allpairs_vs_plain(
        "ala2", "sample_ala2 shape", dict(ALA2, B=2048), "float32", 41,
        ("bwd",), repeat=True, device=True, plain_reps=(3, 1))["bwd"]
    torch.cuda.empty_cache()
    return rec


# vi_ala2.yaml and vi_molecule_ff.yaml (100 x 100 and 50 x 100 steps) cut
# to one epoch of FF_STEPS steps, every width and option as committed
FF_STEPS = 10
MOLECULE_FF = dict(B=256, N=4, nf=3, H=64)


def ala2_sample(card, vi):
    """``example/sample_ala2.yaml`` as committed (2048 particles, 10 temps,
    float32) from the checkpoint that ``vi`` (vi_ala2.yaml) wrote, in its
    working directory: 260 f32 K1 and 255 tiled f32 K2, beta 1, the npz's
    dihedrals and phi/psi profiles."""
    import numpy as np
    import torch
    from enflow_tpu_torch.ops import egcl_allpairs as ops

    main = config_driver(Path.cwd(), "sample_ala2.yaml")
    sec = main.args["sampling"]
    P, n_iter = sec["n_particles"], main.n_iter
    reset_counts()
    res, secs = timed_sample(main)
    n_vg = 1 + sec["n_temps"] * sec["mcmc_steps"] * sec["n_leapfrog"]
    want = dict(k1=n_iter + n_vg * n_iter, k2=n_vg * n_iter, k2_params=0,
                plain=0)
    got, k2_f32 = vi_launches(), ops.counts.bwd_f32_launches
    require(got == want and k2_f32 == want["k2"],
            f"sample_ala2 launches {got} (tiled f32 K2 {k2_f32}) != {want}")
    check_smc(res, "sample_ala2", P, 22)
    require(res.particles["pos"].is_cuda and res.log_weights.is_cuda
            and res.particles["pos"].dtype == torch.float32,
            "sample_ala2: particles not float32 on the card")
    bins = sec["fe_bins"]
    with np.load(sec["output"]) as z:
        shapes = {k: z[k].shape for k in ("dihedrals", "phi_free_energy",
                                          "psi_free_energy")}
        require(shapes == {"dihedrals": (P, 23), "phi_free_energy": (bins,),
                           "psi_free_energy": (bins,)},
                f"sample_ala2 npz shapes {shapes}")
        fe = {k: z[k] for k in ("phi_free_energy", "psi_free_energy")}
    for k, F in fe.items():
        fin = F[np.isfinite(F)]
        require(fin.size and fin.min() == 0.0,
                f"sample_ala2 {k}: no finite minimum of 0 ({F})")
    phase("ala2", f"sample_ala2.yaml as committed from the vi_ala2 "
          f"checkpoint on {card}: {P} particles x {sec['n_temps']} temps, "
          f"float32, {secs:.3f} s, log_Z {float(res.log_Z):.4f}; launches "
          f"f32 K1 {got['k1']}, tiled f32 K2 {k2_f32} ({n_vg} "
          f"value-and-grads), plain calls 0; dihedrals {shapes['dihedrals']}"
          ", phi/psi profiles of " + "/".join(
              str(int(np.isfinite(F).sum())) for F in fe.values())
          + f" finite bins of {bins}")
    return dict(k1=got["k1"], k2=k2_f32, secs=secs)


def ala2_phase(card):
    """Alanine dipeptide and the molecular force field. (a)
    ``example/vi_ala2.yaml`` at full width (B=256, N=22, nf=4, H=128,
    float32; the force field in float32 on the card) cut to 1 epoch x
    FF_STEPS steps: 5 f32 K1 + 5 f32 K2 p a step, finite losses, a
    checkpoint and ``ala2_vi_metrics.csv``; then ``sample_ala2.yaml`` as
    committed from that checkpoint (``ala2_sample``). (b)
    ``example/vi_molecule_ff.yaml`` (N=4, nf=3, H=64, float32) cut the same
    way: 4 K1 + 4 K2 p a step; then the f32 K1 and K2 p against their plain
    version at its shape (B=256, N=4, nf=3, H=64), a second launch bitwise
    equal. (c) ``ala2_kernels``."""
    import torch

    def check(main):
        require(main.vi_n_atoms == 22 and main._ff.sigma.dtype
                == torch.float32 and main._ff.sigma.is_cuda,
                f"vi_ala2: {main.vi_n_atoms} atoms, force field "
                f"{main._ff.sigma.dtype} on {main._ff.sigma.device}")

    def after(vi):
        with open("ala2_vi_metrics.csv") as f:
            rows = [r.split(",") for r in f.read().strip().splitlines()]
        require(rows[0][:3] == ["time", "epoch", "loss"] and len(rows) == 2
                and math.isfinite(float(rows[1][2])),
                f"ala2_vi_metrics.csv rows {rows}")
        return ala2_sample(card, vi)

    vi = vi_config_phase(card, "ala2", "vi_ala2.yaml", FF_STEPS, 5, ALA2,
                         "float32", check=check, after=after, kinds=())
    mol = vi_config_phase(card, "ala2", "vi_molecule_ff.yaml", FF_STEPS, 4,
                          MOLECULE_FF, "float32", repeat=True)
    rec = ala2_kernels()
    return dict(vi=vi, molecule=mol, rec=rec)


def lj13_launches(n_iter, n_vg, extra_fwd=0):
    """The launches of a run that draws its starts with one flow reverse
    and then takes ``n_vg`` flow value-and-grads (and ``extra_fwd`` flow
    forwards without a gradient)."""
    return dict(k1=n_iter * (1 + n_vg + extra_fwd), k2=n_iter * n_vg,
                k2_params=0, plain=0)


def on_card(tree):
    import torch
    leaves = tree.values() if isinstance(tree, dict) else [tree]
    return all(isinstance(t, torch.Tensor) and t.is_cuda
               and bool(torch.isfinite(t).all()) for t in leaves)


# sample_lj13_mcmc.yaml's nuts run cut to NUTS_CUT sweeps (kept, warmup)
NUTS_CUT = dict(n_samples=10, n_warmup=5)


def mcmc_phase(card, lj13_dir):
    """``example/sample_lj13_mcmc.yaml`` from the LJ13 VI checkpoint in
    ``lj13_dir`` for ``algo: hmc`` (as committed: 64 chains, dual
    averaging over 100 steps, 200 kept sweeps of 5 steps of 5 leapfrog
    steps), ``mala`` (the same sweeps) and ``nuts`` (NUTS_CUT, max depth
    8): one flow reverse of the 64 starts (5 bf16 K1), then the chains on
    the LJ energy and the auxiliary Gaussians alone (no flow launch)."""
    import os
    import numpy as np
    import torch

    cwd = os.getcwd()
    out = {}
    try:
        for algo in ("hmc", "mala", "nuts"):
            over = dict(algo=algo, output=f"lj13_mcmc_{algo}.npz")
            if algo == "nuts":
                over.update(NUTS_CUT)
            main = config_driver(lj13_dir, "sample_lj13_mcmc.yaml", over=over)
            sec = main.args["sampling"]
            reset_counts()
            torch.cuda.synchronize()
            t = time.perf_counter()
            samples = main.sample()
            torch.cuda.synchronize()
            secs = time.perf_counter() - t
            got = vi_launches()
            want = lj13_launches(main.n_iter, 0)
            require(got == want, f"mcmc {algo} launches {got} != {want}")
            C, S = sec["n_particles"], sec["n_samples"]
            require(on_card(samples) and tuple(samples["pos"].shape)
                    == (S, C, 13, 3), f"mcmc {algo}: draws not finite on "
                    "the card or of the wrong shape")
            with np.load(sec["output"]) as z:
                stats = {k: float(z[k]) for k in ("accept_rate",
                                                  "step_size", "mean_depth",
                                                  "divergence_rate")
                         if k in z.files}
                require(z["pos"].shape == (S * C, 13, 3),
                        f"mcmc {algo}: npz pos {z['pos'].shape}")
            # kernel steps: hmc's warmup is n_warmup dual-averaging steps,
            # mala's n_warmup sweeps of thin steps; a nuts sweep is one
            # transition
            W, thin = sec["n_warmup"], sec["thin"]
            steps = {"hmc": W + S * thin, "mala": (W + S) * thin,
                     "nuts": W + S}[algo]
            phase("mcmc", f"sample_lj13_mcmc.yaml algo {algo} on {card}: "
                  f"{C} chains, {S} kept sweeps"
                  + (f" of {thin} steps" if algo != "nuts" else "")
                  + f" after {W} warmup "
                  + ("adaptation steps" if algo == "hmc" else "sweeps")
                  + f": {secs:.3f} s, {secs / S:.4f} s a kept sweep "
                  f"(warmup included), {steps} kernel steps at "
                  f"{secs / steps * 1e3:.3f} ms; "
                  + ", ".join(f"{k} {v:.4g}" for k, v in stats.items())
                  + f"; launches K1 {got['k1']} (one reverse), K2 0, "
                  "plain calls 0")
            out[algo] = dict(secs=secs, stats=stats, k1=got["k1"])
    finally:
        os.chdir(cwd)
    return out


# remc_lj13.yaml as committed (6 slots x 512 chains, 200 rounds), with MBAR,
# once monolithic and once in segments of REMC_CHUNK rounds. (Cut to 40
# rounds, 20 discarded, MBAR's last change read 0.0638, past the 1e-2 the
# phase holds it to: the chains had not mixed.)
REMC_CHUNK = 50
REMC = dict(B=3072, N=13, nf=5, H=128)


def remc_phase(card, lj13_dir):
    """``example/remc_lj13.yaml`` at full width from the LJ13 VI checkpoint
    in ``lj13_dir``, with ``mbar: true``, once monolithic and once with
    ``chunk_rounds`` REMC_CHUNK: bitwise equal, MBAR's log_Z finite and its
    last change small; launches: one K*M reverse, one cache fill and
    mcmc_steps x n_leapfrog value-and-grads a round over the flattened
    ladder (bf16 K1/K2 at B=3,072), and two flow forwards for MBAR. Then
    K1 and K2 at B=3,072 against their plain version, timed."""
    import os
    import numpy as np
    import torch

    cwd = os.getcwd()
    runs = {}
    try:
        for label, chunk in (("monolithic", 0), ("chunked", REMC_CHUNK)):
            main = config_driver(lj13_dir, "remc_lj13.yaml", over=dict(
                mbar=True, chunk_rounds=chunk,
                output=f"lj13_remc_{label}.npz"))
            sec = main.args["sampling"]
            reset_counts()
            res, secs = timed_sample(main)
            R = sec["n_rounds"]
            n_vg = 1 + R * sec["mcmc_steps"] * sec["n_leapfrog"]
            want = lj13_launches(main.n_iter, n_vg, extra_fwd=2)
            got = vi_launches()
            require(got == want, f"remc {label} launches {got} != {want}")
            K, M = int(res.betas.shape[0]), sec["n_particles"]
            require(on_card(res.samples) and on_card(res.x_final)
                    and tuple(res.x_final["pos"].shape) == (K, M, 13, 3)
                    and res.swap_accept.is_cuda and res.accept.is_cuda,
                    f"remc {label}: outputs not finite on the card")
            with np.load(sec["output"]) as z:
                arrays = {k: z[k] for k in z.files}
            require(np.isfinite(arrays["mbar_log_Z"])
                    and float(arrays["mbar_converged"]) < 1e-2,
                    f"remc {label}: mbar_log_Z {arrays['mbar_log_Z']}, "
                    f"last change {arrays['mbar_converged']}")
            runs[label] = (res, secs, got, arrays)
    finally:
        os.chdir(cwd)
    (a, secs_a, got, za), (b, secs_b, _, zb) = runs["monolithic"], \
        runs["chunked"]
    diff = [k for k in za if not np.array_equal(za[k], zb[k])]
    diff += [f"samples[{k}]" for k in a.samples
             if not torch.equal(a.samples[k], b.samples[k])]
    R = a.samples["pos"].shape[0]
    phase("remc", f"remc_lj13.yaml as committed from the LJ13 VI checkpoint "
          f"on {card}: {K} temps x {M} chains x {R} rounds, mbar: "
          f"monolithic {secs_a:.3f} s ({secs_a / R * 1e3:.2f} ms a round), "
          f"chunked by {REMC_CHUNK} {secs_b:.3f} s; swap accept "
          + ", ".join(f"{x:.3f}" for x in za["swap_accept"])
          + ", HMC accept " + ", ".join(f"{x:.3f}" for x in za["accept"])
          + f"; mbar_log_Z {float(za['mbar_log_Z']):.4f} +- "
          f"{float(za['mbar_log_Z_se']):.4f}, last change "
          f"{float(za['mbar_converged']):.2e}; launches K1 {got['k1']} K2 "
          f"{got['k2']} each, plain calls 0; chunked == monolithic bit for "
          "bit: " + ("yes" if not diff else f"NO {diff}"))
    require(not diff, f"chunked and monolithic REMC differ in {diff}")
    rec = allpairs_vs_plain("remc", "remc_lj13 shape", REMC, "bfloat16", 47,
                            ("fwd", "bwd"), plain_reps=(5, 2), device=True)
    torch.cuda.empty_cache()
    return dict(secs=secs_a, k1=got["k1"], k2=got["k2"], rec=rec,
                s_round=secs_a / R)


# ti_lj13.yaml (25 nodes x 256 chains, 400 sweeps with 150 warmup) cut to
# TI_CUT sweeps a node, once monolithic and once in segments of TI_CHUNK
TI_CUT = dict(n_samples=4, n_warmup=2)
TI_CHUNK = 3


def ti_phase(card, lj13_dir):
    """``example/ti_lj13.yaml`` from the LJ13 VI checkpoint in ``lj13_dir``
    at its 256 chains and 25 nodes with the sweeps cut to TI_CUT, once
    monolithic and once with ``chunk_steps`` TI_CHUNK: bitwise equal;
    launches: one reverse, then a cache fill and n_leapfrog value-and-grads
    a sweep at every node (bf16 K1/K2 at B=256). Prints the seconds a sweep
    and their extrapolation to the committed 400 sweeps a node."""
    import os
    import warnings
    import torch

    cwd = os.getcwd()
    runs = {}
    try:
        for label, chunk in (("monolithic", None), ("chunked", TI_CHUNK)):
            over = dict(TI_CUT, output=f"lj13_ti_{label}.npz",
                        metrics_csv=f"lj13_ti_nodes_{label}.csv")
            if chunk:
                over["chunk_steps"] = chunk
            main = config_driver(lj13_dir, "ti_lj13.yaml", over=over)
            sec = main.args["sampling"]
            reset_counts()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                res, secs = timed_sample(main)
            K, S = sec["ti_nodes"], sec["n_samples"]
            n_vg = K * (1 + S * sec["n_leapfrog"])
            want = lj13_launches(main.n_iter, n_vg)
            got = vi_launches()
            require(got == want, f"ti {label} launches {got} != {want}")
            require(on_card(res.x) and res.node_mean.is_cuda
                    and math.isfinite(float(res.log_Z)),
                    f"ti {label}: outputs not finite on the card")
            with open(sec["metrics_csv"]) as f:
                rows = f.read().strip().splitlines()
            require(len(rows) == K + 1, f"ti {label}: {len(rows)} CSV rows")
            runs[label] = (res, secs, got, [str(w.message)[:60]
                                            for w in caught])
    finally:
        os.chdir(cwd)
    (a, secs_a, got, warned), (b, secs_b, _, _) = runs["monolithic"], \
        runs["chunked"]
    diff = [f for f in ("log_Z", "se", "quad_err", "node_mean", "node_se",
                        "accept", "step_size")
            if not torch.equal(getattr(a, f), getattr(b, f))]
    diff += [f"x[{k}]" for k in a.x if not torch.equal(a.x[k], b.x[k])]
    sweeps = K * S
    s_sweep = secs_a / sweeps
    phase("ti", f"ti_lj13.yaml from the LJ13 VI checkpoint on {card}: "
          f"{K} nodes x {a.x['pos'].shape[0]} chains, n_samples {S} / "
          f"n_warmup {TI_CUT['n_warmup']} (cut from 400 / 150): monolithic "
          f"{secs_a:.3f} s, chunked by {TI_CHUNK} {secs_b:.3f} s; "
          f"{s_sweep * 1e3:.2f} ms a sweep, so ~{s_sweep * K * 400:.0f} s "
          f"for the committed {K} x 400 sweeps; log_Z "
          f"{float(a.log_Z):.4f} +- {float(a.se):.4f} (quad_err "
          f"{float(a.quad_err):.4f}), accept at beta 0 / 1 "
          f"{float(a.accept[0]):.3f} / {float(a.accept[-1]):.3f}"
          + (f", warned: {warned}" if warned else "")
          + f"; launches K1 {got['k1']} K2 {got['k2']} each, plain calls 0;"
          " chunked == monolithic bit for bit: "
          + ("yes" if not diff else f"NO {diff}"))
    require(not diff, f"chunked and monolithic TI differ in {diff}")
    return dict(secs=secs_a, k1=got["k1"], k2=got["k2"], s_sweep=s_sweep)


# phase probe: sample_lj13.yaml in the top-k format at a truncating
# capacity (8 of 12 neighbours) and at N - 1, and remc_lj13.yaml cut to
# PROBE_REMC's rounds
PROBE_CAP, PROBE_FULL, PROBE_CHUNK = 8, 12, 3
PROBE_REMC = dict(n_rounds=20, discard_rounds=10)
PROBE_REMC_CHUNK = 5


def run_captured(fn):
    """``(fn(), stderr text)``: the standard error captured (and written
    out when ``fn`` raises)."""
    import contextlib
    import io
    buf = io.StringIO()
    try:
        with contextlib.redirect_stderr(buf):
            out = fn()
    except BaseException:
        sys.stderr.write(buf.getvalue())
        raise
    return out, buf.getvalue()


def edge_launches():
    """K5/K6 launches, all-pairs launches and plain calls since the counts
    were reset."""
    from enflow_tpu_torch.ops import edge_pipeline as ep
    from enflow_tpu_torch.ops import egcl_allpairs as ea
    c = ea.counts
    return dict(k5=ep.counts.fwd_launches, k6=ep.counts.bwd_launches,
                allpairs=(c.fwd_launches + c.bwd_launches
                          + c.bwd_f32_launches + c.bwd_param_launches),
                plain=plain_calls())


def edge_routes():
    """K5/K6 launches by kernel since the counts were reset: ``{route:
    (K5, K6)}`` for each route of ops/edge_pipeline.py (the Hopper bf16
    kernels at 64/128 and 192/256, the tiled f32 ones at the same) and
    ``padded`` (the launches of any route at a padded width)."""
    from enflow_tpu_torch.ops import edge_pipeline as ep
    c = ep.counts
    return {r: (getattr(c, f"{r}_fwd_launches"),
                getattr(c, f"{r}_bwd_launches"))
            for r in ep.ROUTES + ("padded",)}


def read_csv(path):
    import csv
    with open(path) as f:
        return list(csv.DictReader(f))


def npz_arrays(path):
    import numpy as np
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def probe_phase(card, lj13_dir):
    """The sampling overflow probe on the card (see the module docstring,
    phase 8e). Returns the monolithic top-k run's launches and seconds and
    the probe's time."""
    import os
    import numpy as np
    import torch

    topk = lambda cap: dict(nbr_mode="topk", nbr_capacity=cap)  # noqa: E731
    cwd = os.getcwd()
    runs = {}
    try:
        for label, cap, chunk in (("monolithic", PROBE_CAP, 0),
                                  ("chunked", PROBE_CAP, PROBE_CHUNK),
                                  ("exact", PROBE_FULL, 0)):
            main = config_driver(lj13_dir, "sample_lj13.yaml", over=dict(
                chunk_temps=chunk, output=f"probe_{label}.npz",
                metrics_csv=f"probe_{label}.csv"), dynamics=topk(cap))
            sec = main.args["sampling"]
            reset_counts()
            (res, secs), err = run_captured(lambda: timed_sample(main))
            got = edge_launches()
            T = sec["n_temps"]
            n_vg = 1 + T * sec["mcmc_steps"] * sec["n_leapfrog"]
            # a reverse for the starts, the value-and-grads, a probe a stage
            want = dict(k5=main.n_iter * (1 + n_vg + T),
                        k6=main.n_iter * n_vg, allpairs=0, plain=0)
            require(got == want, f"probe {label} launches {got} != {want}")
            # every bf16 K5/K6 launch on the Hopper kernels
            routes = edge_routes()
            require(routes == route_counts("sm90", want["k5"], want["k6"]),
                    f"probe {label}: K5/K6 launches by kernel {routes}")
            P = sec["n_particles"]
            check_smc(res, f"probe {label}", P, 13)
            hist = res.stage_metric_history
            require(on_card(res.particles) and hist is not None
                    and hist.is_cuda and res.log_weights.is_cuda
                    and tuple(hist.shape) == (T,),
                    f"probe {label}: outputs not on the card")
            col = [r["nbr_overflow"] for r in read_csv(sec["metrics_csv"])]
            require(len(col) == T and all(c.isdigit() for c in col),
                    f"probe {label}: nbr_overflow column {col}")
            ovf = [int(c) for c in col]
            require(ovf == hist.tolist(),
                    f"probe {label}: CSV {ovf} != history {hist.tolist()}")
            runs[label] = dict(res=res, secs=secs, got=got, ovf=ovf,
                               warned="neighbor slots truncated across the "
                               "anneal stages" in err,
                               arrays=npz_arrays(sec["output"]), main=main,
                               sec=sec)
        mono, chunked, exact = (runs[k] for k in ("monolithic", "chunked",
                                                  "exact"))
        require(sum(mono["ovf"]) > 0 and mono["warned"]
                and chunked["warned"],
                f"no truncation reported at capacity {PROBE_CAP}: "
                f"{mono['ovf']}")
        require(sum(exact["ovf"]) == 0 and not exact["warned"],
                f"capacity {PROBE_FULL} reported truncation {exact['ovf']}")
        diff = [k for k in mono["arrays"]
                if not np.array_equal(mono["arrays"][k],
                                      chunked["arrays"][k])]
        if mono["ovf"] != chunked["ovf"]:
            diff.append("nbr_overflow")
        require(not diff, f"chunked and monolithic probe runs differ in "
                f"{diff}")

        # the probe alone, on the monolithic run's final particles
        main, sec = mono["main"], mono["sec"]
        fn = main._overflow_stage_fn(sec)
        x = mono["res"].particles
        probe_ms = cuda_time_ms(lambda: fn(x), reps=10, calls=3)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(10):
            int(fn(x))
        probe_host_ms = (time.perf_counter() - t) / 10 * 1e3
        T = sec["n_temps"]
        share = T * probe_ms / (mono["secs"] * 1e3)

        # REMC: the probe once a round over the flattened ladder
        remc_runs = {}
        for label, chunk in (("monolithic", 0),
                             ("chunked", PROBE_REMC_CHUNK)):
            rm = config_driver(lj13_dir, "remc_lj13.yaml", over=dict(
                PROBE_REMC, chunk_rounds=chunk,
                output=f"probe_remc_{label}.npz",
                metrics_csv=f"probe_remc_{label}.csv"),
                dynamics=topk(PROBE_CAP))
            rsec = rm.args["sampling"]
            reset_counts()
            (rres, rsecs), err = run_captured(lambda: timed_sample(rm))
            got = edge_launches()
            R = rsec["n_rounds"]
            n_vg = 1 + R * rsec["mcmc_steps"] * rsec["n_leapfrog"]
            want = dict(k5=rm.n_iter * (1 + n_vg + R), k6=rm.n_iter * n_vg,
                        allpairs=0, plain=0)
            require(got == want, f"probe remc {label} launches {got} != "
                    f"{want}")
            routes = edge_routes()
            require(routes == route_counts("sm90", want["k5"], want["k6"]),
                    f"probe remc {label}: K5/K6 launches by kernel {routes}")
            h = rres.round_metric_history
            require(h is not None and h.is_cuda and tuple(h.shape) == (R,)
                    and on_card(rres.samples),
                    f"probe remc {label}: round_metric_history {h}")
            rows = read_csv(rsec["metrics_csv"])
            total = int(h.sum())
            require([r["nbr_overflow"] for r in rows]
                     == [""] * (len(rows) - 1) + [str(total)] and total > 0
                     and "truncated across the REMC rounds" in err,
                     f"probe remc {label}: CSV column "
                     f"{[r['nbr_overflow'] for r in rows]}, total {total}")
            remc_runs[label] = (rres, rsecs, got, npz_arrays(rsec["output"]))
        (ra, rsa, rgot, za), (rb, rsb, _, zb) = (remc_runs["monolithic"],
                                                 remc_runs["chunked"])
        rdiff = [k for k in za if not np.array_equal(za[k], zb[k])]
        if not torch.equal(ra.round_metric_history,
                           rb.round_metric_history):
            rdiff.append("round_metric_history")
        require(not rdiff, f"chunked and monolithic REMC differ in {rdiff}")
    finally:
        os.chdir(cwd)
    g = mono["got"]
    phase("probe", f"sample_lj13.yaml (topk, nbr_capacity {PROBE_CAP}) on "
          f"{card}: {mono['secs']:.3f} s monolithic, {chunked['secs']:.3f} s "
          f"chunked by {PROBE_CHUNK}, bitwise equal with the column; "
          f"nbr_overflow a stage " + " ".join(map(str, mono["ovf"]))
          + f" (sum {sum(mono['ovf'])}), warning printed; launches K5 "
          f"{g['k5']} K6 {g['k6']}, every one on the Hopper kernels "
          f"(edge_pipeline_sm90.cu; tiled and chunked 0), all-pairs 0, plain "
          f"calls 0; at capacity "
          f"{PROBE_FULL}: {exact['secs']:.3f} s, column all 0, no warning; "
          f"log_Z {float(mono['res'].log_Z):.4f} (cap {PROBE_CAP}) / "
          f"{float(exact['res'].log_Z):.4f} (cap {PROBE_FULL})")
    n_probe = min(256, x["pos"].shape[0])
    phase("probe", f"the probe alone ({n_probe} of {x['pos'].shape[0]} "
          f"particles, 5 K5 at A = {n_probe * 13}): {probe_ms:.4f} ms "
          f"(events), {probe_host_ms:.4f} ms (host clock, synchronized "
          f"by the count's read); x {T} stages = {share:.4f} of the "
          f"monolithic run")
    phase("probe", f"remc_lj13.yaml (topk, nbr_capacity {PROBE_CAP}, "
          f"{PROBE_REMC['n_rounds']} rounds) on {card}: {rsa:.3f} s "
          f"monolithic, {rsb:.3f} s in segments of {PROBE_REMC_CHUNK}, "
          f"bitwise equal; a probe a round: "
          + " ".join(str(int(v)) for v in ra.round_metric_history)
          + f" (CSV total {int(ra.round_metric_history.sum())}); launches "
          f"K5 {rgot['k5']} K6 {rgot['k6']}, every one on the Hopper "
          f"kernels, plain calls 0")
    torch.cuda.empty_cache()
    return dict(k5=g["k5"], k6=g["k6"], secs=mono["secs"],
                probe_ms=probe_ms, share=share)


# phase data: train.yaml with a compose of its lj dataset and an md dataset
# of the same frames; epochs with the guard and profiler, then without
DATA_EPOCHS_GUARDED = 2
DATA_SAMPLES = 2 * 91
DATA_STEPS = -(-DATA_SAMPLES // 30)


def write_md_files(samples, gro, trr, xyz):
    """A ``.gro`` topology and a ``.trr`` trajectory (nm, nm/ps, box and
    velocities) of reduced-unit samples, and an ``.xyz`` (Angstrom) of the
    positions that the ``.trr`` gives back."""
    import numpy as np
    from enflow_tpu_torch.data import formats, readers
    from enflow_tpu_torch.utils import conversion as cv
    from enflow_tpu_torch.utils.constants import sigma

    to_nm = sigma * 1e9
    frames = [{"step": i, "time": 0.0, "box": np.diag(s.box * to_nm),
               "pos": s.pos * to_nm,
               "vel": cv.lj_to_vel(s.vel, "nm", "pico")}
              for i, s in enumerate(samples)]
    formats.write_trr(trr, frames)
    first = frames[0]
    with open(gro, "w") as f:
        f.write(f"lj\n{len(first['pos']):5d}\n")
        for i, p in enumerate(first["pos"], start=1):
            f.write("%5d%-5s%5s%5d%8.3f%8.3f%8.3f\n" % (1, "LJ", "Ar", i,
                                                         *p))
        f.write("%10.5f%10.5f%10.5f\n" % tuple(np.diag(first["box"])))
    scale = readers._dist_scale("nm", "ang")
    with open(xyz, "w") as f:
        for fr in formats.read_trr(trr):
            pos = fr["pos"] * scale
            f.write(f"{len(pos)}\n \n")
            for x in pos:
                f.write("Ar %.18g %.18g %.18g\n" % tuple(x))


def data_yaml(tmp, name, epochs, checkpoint, guarded=False, compose=True):
    """example/train.yaml with ``epochs`` and ``checkpoint``, its dataset
    replaced by phase data's compose unless ``compose`` is false, and the
    profiler and NaN guard when ``guarded``."""
    import yaml
    cfg = yaml.safe_load((ROOT / "example" / "train.yaml").read_text())
    lj = cfg["dataset"]
    if compose:
        cfg["dataset"] = {"type": "compose", "number": 2}
        cfg["dataset1"] = lj
        cfg["dataset2"] = {"type": "md", "top_file": "lj.gro",
                           "traj_file": "lj.trr", "r_cut": lj["r_cut"],
                           "box": lj["box"], "atom_types": ["Ar"]}
    cfg["training"]["num_epochs"] = epochs
    cfg["dynamics"]["checkpoint_path"] = checkpoint
    if guarded:
        cfg["training"]["profile_dir"] = "prof"
        cfg["debug"] = {"nan_checks": True}
    path = Path(tmp) / name
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def timed_train(main):
    """Run ``main.train()``; returns (seconds of each step, losses)."""
    import torch
    step_s, losses = [], []
    inner = main.train_step

    def timed(batch, gen):
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss, ovf = inner(batch, gen)
        losses.append(float(loss))          # synchronizes
        step_s.append(time.perf_counter() - t)
        return loss, ovf
    main.train_step = timed
    main.train()
    torch.cuda.synchronize()
    return step_s, losses


def train_launches():
    from enflow_tpu_torch.ops import pair_energy as pe
    got = edge_launches()
    got.update(k7_r2=pe.counts.r2_launches, k7_r=pe.counts.r_launches)
    return got


def want_train(n_steps):
    return dict(k5=5 * n_steps, k6=5 * n_steps, allpairs=0, plain=0,
                k7_r2=n_steps, k7_r=0)


def data_phase(card, tmp):
    """Phase data (the module docstring's 10h) in the working directory
    ``tmp``, which phase import then shares (its cached lj dataset)."""
    import os
    import yaml
    import numpy as np
    import torch
    from enflow_tpu_torch.data import readers
    from enflow_tpu_torch.train.driver import Main

    cwd = os.getcwd()
    try:
        os.chdir(tmp)
        cfg = yaml.safe_load((ROOT / "example" / "train.yaml").read_text())
        lj_sec = cfg["dataset"]
        cfg["mode"] = "dataset"
        Path("lj.yaml").write_text(yaml.safe_dump(cfg))
        t0 = time.perf_counter()
        lj = Main(device="cuda")("lj.yaml")
        md_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        write_md_files(lj.samples, "lj.gro", "lj.trr", "lj.xyz")
        write_s = time.perf_counter() - t0

        main = Main(device="cuda")
        t0 = time.perf_counter()
        main.setup(data_yaml(tmp, "data.yaml", DATA_EPOCHS_GUARDED,
                             "data.cpt", guarded=True))
        setup_s = time.perf_counter() - t0
        ds = main.dataset
        require(len(ds) == DATA_SAMPLES and main.node_nf == 1
                and len({s.node_nf for s in ds.samples}) == 1,
                f"compose: {len(ds)} samples, node_nf {main.node_nf}")
        n = len(lj)
        for a, b in zip(ds.samples[:n], ds.samples[n:]):
            require(np.abs(a.pos - b.pos).max() < 1e-5,
                    "the md part's frames are not the lj part's")
        reset_counts()
        on_s, on_losses = timed_train(main)
        got = train_launches()
        n_on = DATA_EPOCHS_GUARDED * DATA_STEPS
        require(len(on_s) == n_on and got == want_train(n_on),
                f"guarded epochs: {len(on_s)} steps, launches {got} != "
                f"{want_train(n_on)}")
        require(all(math.isfinite(x) for x in on_losses),
                f"non-finite losses {on_losses}")
        require(not torch.is_anomaly_enabled(), "anomaly mode left on")
        traces = sorted(Path("prof").glob("*.json"))
        require(len(traces) == 1, f"profile_dir holds {traces}")
        trace_text = traces[0].read_text()
        require("edge_tiled_fwd_kernel" in trace_text
                and "edge_tiled_bwd_kernel" in trace_text,
                "the trace does not name the edge kernels")
        trace_mb = traces[0].stat().st_size / 2 ** 20

        off = Main(device="cuda")
        off.setup(data_yaml(tmp, "data_off.yaml", 1, "data.cpt"))
        require(off.start_epoch == DATA_EPOCHS_GUARDED and not off.nan_checks
                and not off.profile_dir, "the unguarded run did not resume")
        reset_counts()
        off_s, off_losses = timed_train(off)
        require(train_launches() == want_train(DATA_STEPS)
                and all(math.isfinite(x) for x in off_losses),
                f"unguarded epoch: launches {train_launches()}, losses "
                f"{off_losses}")

        # one NaN parameter: the guard raises at the first step's loss
        raised = {}
        for guarded in (True, False):
            nan = Main(device="cuda")
            nan.setup(data_yaml(tmp, f"nan_{guarded}.yaml", 1,
                                f"nan_{guarded}.cpt"))
            nan.nan_checks = guarded
            with torch.no_grad():
                nan.params["networks"]["edge_nn"][0]["w"][0, 0, 0] = \
                    float("nan")
            try:
                run_captured(nan.train)
                raised[guarded] = None
            except FloatingPointError as e:
                raised[guarded] = str(e)
        require(raised[True] and "loss" in raised[True]
                and raised[False] is None,
                f"NaN parameter: guarded {raised[True]!r}, unguarded "
                f"{raised[False]!r}")
        require(not torch.is_anomaly_enabled(), "anomaly mode left on")

        # largemd streams the .trr / .xyz that md reads in memory
        kw = dict(top_file="lj.gro", r_cut=lj_sec["r_cut"], box=lj_sec["box"],
                  atom_types=["Ar"], seed=5, device="cuda")
        md = readers.MDDataset(traj_file="lj.trr", **kw)
        big = {ext: readers.LargeMDDataset(traj_file=f"lj.{ext}", **kw)
               for ext in ("trr", "xyz")}
        for ext, lg in big.items():
            a, b = md[0], lg[0]
            fields = ("h", "g", "pos", "vel", "box") if ext == "trr" \
                else ("h", "g", "pos", "box")
            require(len(lg) == len(md) == n and lg.max_atoms == md.max_atoms
                    and a.z == b.z and all(np.array_equal(getattr(a, f),
                                                          getattr(b, f))
                                           for f in fields),
                    f"largemd .{ext} differs from md")
    finally:
        os.chdir(cwd)
    s_on = statistics.median(on_s[1:DATA_STEPS])
    s_off = statistics.median(off_s)
    s_prof = statistics.median(on_s[DATA_STEPS:])
    phase("data", f"train.yaml with compose (lj + md of its frames) on "
          f"{card}: lj dataset {md_s:.3f} s (MD on the card), .gro/.trr/"
          f".xyz written in {write_s:.4f} s, compose set-up "
          f"{setup_s:.3f} s; {len(ds)} samples, node_nf 1, {DATA_STEPS} "
          f"steps an epoch; launches per step K5 5 K6 5 K7 r2 1, plain "
          f"calls 0; s/step with the NaN guard {s_on:.5f} (epoch 0, steps "
          f"2-{DATA_STEPS}), guard + profiler {s_prof:.5f} (epoch 1), "
          f"neither {s_off:.5f} (epoch 2): guard x{s_on / s_off:.2f}; "
          f"trace {traces[0].name} {trace_mb:.2f} MiB names "
          f"edge_tiled_fwd/bwd_kernel; losses {on_losses[0]:.3f} -> "
          f"{off_losses[-1]:.3f}")
    phase("data", f"a NaN parameter: guarded epoch raised "
          f"FloatingPointError ({raised[True]}), unguarded ran; largemd "
          f".trr and .xyz: {n} frames, max_atoms 13, first sample = md's")
    return dict(s_on=s_on, s_off=s_off, s_prof=s_prof)


IMPORT_SEED = 12


def reference_state_dict(node_nf, hidden, n_networks, seed):
    """A state dict in the reference's layout (torch Linear ``[out, in]``,
    float64, torch's default uniform(-1/sqrt(in), 1/sqrt(in)) init) from a
    seeded generator."""
    import torch
    g = torch.Generator().manual_seed(seed)
    sd = {}

    def lin(out_d, in_d, prefix, bias=True):
        b = 1.0 / math.sqrt(in_d)
        u = lambda *shape: (torch.rand(shape, generator=g,  # noqa: E731
                                       dtype=torch.float64) * 2 - 1) * b
        sd[prefix + ".weight"] = u(out_d, in_d)
        if bias:
            sd[prefix + ".bias"] = u(out_d)

    nf, H = node_nf, hidden
    for k in range(n_networks):
        p = f"networks.{k}."
        lin(H, 2 * nf + 1, p + "edge_nn.0")
        lin(H, H, p + "edge_nn.2")
        lin(H, H + nf, p + "node_nn.0")
        lin(nf, H, p + "node_nn.2")
        lin(H, H, p + "coord_nn.0")
        lin(1, H, p + "coord_nn.2", bias=False)
        lin(H, nf, p + "vel_scaling_nn.0")
        lin(1, H, p + "vel_scaling_nn.2")
    lin(H, nf, "dequantize.network.0")
    lin(2 * nf, H, "dequantize.network.2")
    return sd


def cli(module, *args):
    """``python -m module args`` from the working directory, on the card;
    (seconds, stdout)."""
    import os
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    t = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", module, *args], env=env,
                         capture_output=True, text=True)
    secs = time.perf_counter() - t
    require(out.returncode == 0, f"{module} failed: {out.stderr[-2000:]}")
    return secs, out.stdout.strip()


def import_phase(card, tmp):
    """Phase import (the module docstring's 10i) in phase data's working
    directory ``tmp`` (its cached lj dataset: no MD)."""
    import os
    import shutil
    import torch
    from enflow_tpu_torch.train.driver import Main
    from enflow_tpu_torch.utils import conversion as cv

    cwd = os.getcwd()
    try:
        os.chdir(tmp)
        n_iter, H = 5, 128
        sd = reference_state_dict(1, H, n_iter, IMPORT_SEED)
        ref = {"epoch": 0, "model_state_dict": sd,
               "optimizer_state_dict": {}, "node_nf": 1, "hidden_nf": H,
               "softening": 0.1, "lj_kBT": cv.kelvin_to_lj(120.0),
               "integrator": "lf", "n_iter": n_iter,
               "dt": cv.time_to_lj(1.0, unit="pico")}
        torch.save(ref, "reference.cpt")
        imp_s, imp_line = cli("enflow_tpu_torch.utils.torch_import",
                              "reference.cpt", "imported.npz")
        shutil.copy("imported.npz", "import_model.cpt")
        main = Main(device="cuda")
        (_, err) = run_captured(lambda: main.setup(data_yaml(
            tmp, "import.yaml", 1, "import_model.cpt", compose=False)))
        require(main.start_epoch == 1 and "fresh optimizer" in err
                and main.node_nf == 1 and main.hidden_nf == H,
                f"import: start epoch {main.start_epoch}, node_nf "
                f"{main.node_nf}")
        reset_counts()
        step_s, losses = timed_train(main)
        n_steps = TRAIN_STEPS_PER_EPOCH
        got = train_launches()
        require(len(step_s) == n_steps and got == want_train(n_steps)
                and all(math.isfinite(x) for x in losses),
                f"import training: launches {got}, losses {losses}")
        exp_s, exp_line = cli("enflow_tpu_torch.utils.torch_export",
                              "imported.npz", "exported.cpt")
        back = torch.load("exported.cpt", weights_only=False)
        bsd = back["model_state_dict"]
        same = (list(bsd) == list(sd) and all(
            bsd[k].dtype == sd[k].dtype and torch.equal(bsd[k], sd[k])
            for k in sd) and all(back[k] == ref[k] for k in (
                "epoch", "node_nf", "hidden_nf", "softening", "lj_kBT",
                "integrator", "n_iter", "dt")))
        require(same, "the export differs from the reference state dict")
    finally:
        os.chdir(cwd)
    phase("import", f"reference model.cpt (node_nf 1, H={H}, {n_iter} "
          f"networks, {len(sd)} tensors) -> torch_import CLI on {card} in "
          f"{imp_s:.3f} s ({imp_line.split('(')[0].strip()}); 1 epoch of "
          f"train.yaml from it: {n_steps} steps, "
          f"{statistics.median(step_s):.5f} s/step, losses "
          + ", ".join(f"{x:.3f}" for x in losses)
          + f", launches K5 {got['k5']} K6 {got['k6']} K7 r2 "
          f"{got['k7_r2']}, plain calls 0; torch_export CLI in "
          f"{exp_s:.3f} s: the state dict back bit for bit")
    return dict(import_s=imp_s, export_s=exp_s)


# {library: the functions ptxas reported spilling}, from build_phase
BUILD_SPILLS = {}


def build_phase():
    """Fresh builds of every kernel source, one nvcc each, in parallel."""
    from enflow_tpu_torch.ops import build
    names = ("egcl_allpairs_sm90", "egcl_allpairs_f32", "egcl_allpairs_xwide",
             "edge_pipeline", "edge_pipeline_sm90", "edge_pipeline_xwide",
             "pair_energy")
    for name in names:
        build.library_path(name).unlink(missing_ok=True)
    t0 = time.perf_counter()
    built = build.build_all(names)
    for name, (lib, secs, log) in built.items():
        regs = [ln.split(":", 1)[1].strip() for ln in log.splitlines()
                if "registers" in ln]
        # ptxas's performance warnings (e.g. serialized wgmma pipelines)
        warn = sorted({ln.strip() for ln in log.splitlines()
                       if "warning" in ln.lower()})
        # ptxas names each function before its stack and spill line
        spilled, func = [], "?"
        for ln in log.splitlines():
            if "Function properties for" in ln:
                func = ln.rsplit(" ", 1)[-1]
            elif "spill stores" in ln and " 0 bytes spill stores" not in ln:
                spilled.append(f"{func} ({ln.strip()})")
        BUILD_SPILLS[name] = spilled
        phase("build", f"{name}.cu -> {lib.name} in {secs:.1f} s; ptxas: "
              f"{'; '.join(regs)}; functions with spills: {len(spilled)}"
              + "".join(f"\n  {f}" for f in spilled)
              + "".join(f"\n  {w}" for w in warn))
    phase("build", f"all sources in {time.perf_counter() - t0:.1f} s")


def kernel_record(name, src, replaces, launches, err, ms, plain, bnd):
    return {"name": name, "route": "cuda",
            "source": f"enflow_tpu_torch/csrc/{src}", "replaces": replaces,
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain, "bound_ms": bnd[0], "bound_by": bnd[1],
            "library_ms": None}


def main():
    t_start = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ab", nargs="+", default=None, metavar="OLD_CU",
                    help="time the kernels built from earlier sources "
                    "(egcl_allpairs_sm90.cu, egcl_allpairs_f32.cu, "
                    "egcl_allpairs_xwide.cu, edge_pipeline.cu, "
                    "edge_pipeline_sm90.cu or pair_energy.cu; each in turn; "
                    "the bits first where the source computes the same "
                    "function) against the current "
                    "ones, and SMC runs, train.yaml epochs or train.yaml MD "
                    "datasets with each, instead of the phases after the "
                    "build")
    ap.add_argument("--edge-seeds", nargs=2, type=int, default=None,
                    metavar=("FIRST", "LAST"), help="hold the bf16 Hopper "
                    "K5/K6 against their plain version at EDGE_SHAPES and "
                    "phase edge_wide's widths and shapes for input seeds "
                    "FIRST..LAST instead of the phases after the build, and "
                    "print the readings")
    ap.add_argument("--allpairs-seeds", nargs=2, type=int, default=None,
                    metavar=("FIRST", "LAST"), help="hold the bf16 K1, K2 "
                    "and K2 p at SWEEP_SHAPES and H = 64, 96, 128, 160, 192, "
                    "256 against their plain version for input seeds "
                    "FIRST..LAST instead of the phases after the build, and "
                    "print the readings")
    ap.add_argument("--trace-check", type=int, nargs=2, default=None,
                    metavar=("ROUNDS", "MINUTES"), help="trace K5 after the "
                    "build, after phases data and import ROUNDS times, then "
                    "after each of MINUTES idle minutes, instead of the "
                    "phases after the build")
    ap.add_argument("--blocks-plans", action="store_true", help="time the "
                    "bf16 block-pair kernels at LJ147 with each block size "
                    "instead of the phases after the build")
    ap.add_argument("--xwide-ablate", action="store_true", help="time the "
                    "bf16 K1 / K2 past H = 256 beside builds with one part "
                    "removed (XWIDE_ABLATE) instead of the phases after the "
                    "build")
    ap.add_argument("--profile", nargs="?", const="", default=None,
                    metavar="FILE", help="profile one SMC run instead of "
                    "the phases after the build; the full table to FILE")
    ap.add_argument("--profile-train", nargs="?", const="", default=None,
                    metavar="FILE", help="profile one train.yaml epoch "
                    "instead of the phases after the build")
    ap.add_argument("--profile-generate", nargs="?", const="", default=None,
                    metavar="FILE", help="profile generate.yaml's flow and "
                    "its MD cut to 1,000 steps instead of the phases after "
                    "the build")
    ap.add_argument("--profile-vi", nargs="?", const="", default=None,
                    metavar="FILE", help="profile one vi_lj13.yaml epoch "
                    "instead of the phases after the build")
    ap.add_argument("--profile-samplers", nargs="?", const="", default=None,
                    metavar="FILE", help="profile REMC, TI and HMC runs "
                    "(cut) and sample_ala2.yaml instead of the phases after "
                    "the build; the tables to FILE.<config>")
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
    build_phase()

    # the drivers run from temporary directories: resolve FILE first
    table = lambda f: Path(f).resolve() if f else None
    if args.ab is not None:
        for src in args.ab:
            ab_phase(card, Path(src).resolve())
        return 0
    if args.edge_seeds is not None:
        edge_seed_sweep(*args.edge_seeds)
        return 0
    if args.allpairs_seeds is not None:
        allpairs_seed_sweep(*args.allpairs_seeds)
        return 0
    if args.blocks_plans:
        blocks_plans()
        return 0
    if args.xwide_ablate:
        xwide_ablate_phase(card)
        return 0
    if args.trace_check is not None:
        trace_check(card, *args.trace_check)
        return 0
    if args.profile is not None:
        profile_smc(card, table(args.profile))
        return 0
    if args.profile_train is not None:
        profile_train(card, table(args.profile_train))
        return 0
    if args.profile_vi is not None:
        profile_vi(card, table(args.profile_vi))
        return 0
    if args.profile_generate is not None:
        profile_generate(card, table(args.profile_generate))
        return 0
    if args.profile_samplers is not None:
        profile_samplers(card, table(args.profile_samplers))
        return 0
    def timed(name, fn, *a):
        t = time.perf_counter()
        out = fn(*a)
        phase(name, f"phase seconds {time.perf_counter() - t:.1f}")
        return out

    rec, largest, _ = timed("kernel", kernel_phase)
    qrec = timed("params", param_kernel_phase, largest["bf16 bwd_params"])
    prec = timed("pair", pair_kernel_phase)
    timed("flow", flow_phase)
    timed("flags", flags_phase)
    n_fwd, n_bwd = timed("smc", smc_phase, card)
    # the samplers of mcmc, remc and ti start from the VI phase's LJ13
    # checkpoint
    with tempfile.TemporaryDirectory() as lj13_dir:
        vi = timed("vi", vi_phase, card, lj13_dir)
        timed("mcmc", mcmc_phase, card, lj13_dir)
        rm = timed("remc", remc_phase, card, lj13_dir)
        timed("ti", ti_phase, card, lj13_dir)
        pr = timed("probe", probe_phase, card, lj13_dir)
    # phase sharded samples from the LJ55 checkpoint that vi55 writes
    with tempfile.TemporaryDirectory() as lj55_dir:
        timed("vi55", vi55_phase, card, lj55_dir)
        timed("sharded", sharded_phase, card, lj55_dir)
    timed("lj55", lj55_phase, card)
    lj147 = timed("lj147", lj147_phase, card)
    lj147f = timed("lj147_f32", lj147_f32_phase, card)
    wide = timed("wide", wide_phase, card)
    wf = timed("wide_f32", wide_f32_phase, card)
    wn = timed("wide_nf", wide_nf_phase, card)
    xw = timed("xwide", xwide_phase, card)
    timed("fluid", fluid_phase, card)
    dw4 = timed("dw4", dw4_phase, card)
    ala2 = timed("ala2", ala2_phase, card)
    # generate reads the checkpoint that train writes, in the same cwd
    with tempfile.TemporaryDirectory() as tmp:
        tr = timed("train", train_phase, card, tmp)
        gen = timed("generate", generate_phase, card, tmp)
        timed("dataset", dataset_phase, card, tmp, gen)
    # compose, the readers, the profiler and NaN guard; then the reference
    # checkpoint's import, training and export on data's cached dataset
    with tempfile.TemporaryDirectory() as tmp:
        timed("data", data_phase, card, tmp)
        timed("import", import_phase, card, tmp)
    # K5/K6 at the training path's shape (its slot count the auto capacity
    # that the train phase's dataset gave) and K5 at generate's
    erec = timed("edge", edge_kernel_phase, tr["capacity"], gen)
    # K5/K6 at 128 < H <= 256 (and padded), generate's shape from its run
    ew = timed("edge_wide", edge_wide_phase, card, gen)
    # K5/K6 past H = 256 and past the C limits of the routes up to 256
    ex = timed("edge_xwide", edge_xwide_phase, card)

    m = rec[("main", "bfloat16")]
    q = qrec[("vi", "bfloat16")]
    e = erec[("main", "float32")]
    v3 = "enflow_tpu/ops/egcl_fused_v3.py"
    kernels = [
        kernel_record("egcl_allpairs_fwd", "egcl_allpairs_sm90.cu",
                      f"{v3}:365", n_fwd, m["err_fwd"], m["ms_fwd"],
                      m["plain_fwd"], m["bound_fwd"]),
        kernel_record("egcl_allpairs_bwd", "egcl_allpairs_sm90.cu",
                      f"{v3}:414", n_bwd, m["err_bwd"], m["ms_bwd"],
                      m["plain_bwd"], m["bound_bwd"]),
        kernel_record("egcl_allpairs_bwd_params", "egcl_allpairs_sm90.cu",
                      f"{v3}:414", vi["k2_params"], q["err"], q["ms"],
                      q["plain"], q["bound"]),
        kernel_record("edge_pipeline_fwd", "edge_pipeline.cu",
                      "enflow_tpu/ops/edge_kernel.py:219", tr["k5"],
                      e["err_fwd"], e["ms_fwd"], e["plain_fwd"],
                      e["bound_fwd"]),
        kernel_record("edge_pipeline_bwd", "edge_pipeline.cu",
                      "enflow_tpu/ops/edge_kernel.py:246", tr["k6"],
                      e["err_bwd"], e["ms_bwd"], e["plain_bwd"],
                      e["bound_bwd"]),
    ]
    # the tiled f32 kernels at vi_dw4.yaml's shape, with that run's launches
    for name, direction, line, n in (
            ("egcl_allpairs_f32_fwd", "fwd", 365, dw4["launches"]["k1"]),
            ("egcl_allpairs_f32_bwd_params", "bwd_params", 414,
             dw4["launches"]["k2_params"])):
        err, ms, plain, bnd, _ = dw4["rec"][direction]
        kernels.append(kernel_record(name, "egcl_allpairs_f32.cu",
                                     f"{v3}:{line}", n, err, ms, plain, bnd))
    # the tiled f32 input-gradient K2 at the same shape, with the launches
    # of the f32 flow-SMC run from vi_dw4.yaml's checkpoint
    err, ms, plain, bnd, _ = dw4["rec"]["bwd"]
    kernels.append(kernel_record("egcl_allpairs_f32_bwd",
                                 "egcl_allpairs_f32.cu", f"{v3}:414",
                                 dw4["after"]["k2"], err, ms, plain, bnd))
    # the tiled f32 K1 / K2 p at vi_ala2.yaml's shape with that run's
    # launches, and the f32 K2 at sample_ala2.yaml's B=2048 with its
    ala2_vi, ala2_rec = ala2["vi"], ala2["rec"]
    for name, direction, line, n in (
            ("egcl_allpairs_f32_fwd_ala2", "fwd", 365,
             ala2_vi["launches"]["k1"]),
            ("egcl_allpairs_f32_bwd_params_ala2", "bwd_params", 414,
             ala2_vi["launches"]["k2_params"]),
            ("egcl_allpairs_f32_bwd_ala2", "bwd_2048", 414,
             ala2_vi["after"]["k2"])):
        err, ms, plain, bnd, _ = ala2_rec[direction]
        kernels.append(kernel_record(name, "egcl_allpairs_f32.cu",
                                     f"{v3}:{line}", n, err, ms, plain, bnd))
    # bf16 K1 / K2 at remc_lj13.yaml's flattened ladder (B=3,072), with the
    # launches of its monolithic run
    for name, direction, line, n in (
            ("egcl_allpairs_fwd_remc", "fwd", 365, rm["k1"]),
            ("egcl_allpairs_bwd_remc", "bwd", 414, rm["k2"])):
        err, ms, plain, bnd, _ = rm["rec"][direction]
        kernels.append(kernel_record(name, "egcl_allpairs_sm90.cu",
                                     f"{v3}:{line}", n, err, ms, plain, bnd))
    for name, key, n in (("pair_energy_r2", "r2", tr["k7_r2"]),
                         ("pair_energy_r", "r", tr["md_launches"]),
                         ("pair_energy_r_generate", "r_generate",
                          gen["k7_r"])):
        p = prec[key]
        kernels.append(kernel_record(
            name, "pair_energy.cu", "enflow_tpu/ops/pairwise_kernel.py:119",
            n, p["err"], p["ms"], p["plain"], p["bound"]))
    # K5 at generate.yaml's shape, with that run's launches
    g = erec[("generate", "float32")]
    kernels.append(kernel_record(
        "edge_pipeline_fwd_generate", "edge_pipeline.cu",
        "enflow_tpu/ops/edge_kernel.py:219", gen["k5"], g["err_fwd"],
        g["ms_fwd"], g["plain_fwd"], g["bound_fwd"]))
    # bf16 K5/K6 at the top-k sampler's shape (the Hopper kernels), with
    # phase probe's launches
    sp = erec[("sampler", "bfloat16")]
    for name, d, line in (("fwd", "fwd", 219), ("bwd", "bwd", 246)):
        kernels.append(kernel_record(
            f"edge_pipeline_{name}_sampler", "edge_pipeline_sm90.cu",
            f"enflow_tpu/ops/edge_kernel.py:{line}",
            pr["k5" if d == "fwd" else "k6"], sp[f"err_{d}"], sp[f"ms_{d}"],
            sp[f"plain_{d}"], sp[f"bound_{d}"]))
    # the bf16 block-pair kernels at LJ147 (B=256), with phase lj147's
    # launches: K1 of its VI and SMC runs, K2 p of the VI, K2 of the SMC
    for name, direction, line, n in (
            ("egcl_allpairs_blocks_fwd", "fwd", 365, lj147["k1"]),
            ("egcl_allpairs_blocks_bwd", "bwd", 414, lj147["k2"]),
            ("egcl_allpairs_blocks_bwd_params", "bwd_params", 414,
             lj147["k2_params"])):
        r = lj147["rec"][direction]
        kernels.append(kernel_record(name, "egcl_allpairs_sm90.cu",
                                     f"{v3}:{line}", n, r["err"], r["ms"],
                                     r["plain"], r["bound"]))
    # the f32 block-pair kernels with phase lj147_f32's launches: K1 of its
    # VI and LJ147 SMC runs, K2 p of the VI, K1 and K2 of the LJ561 SMC run
    # (at its shape, B=16, N=561); the tiled f32 K2 at LJ147 (B=256) with
    # the LJ147 SMC run's launches
    for name, key, line, n in (
            ("egcl_allpairs_f32_blocks_fwd", "fwd", 365, lj147f["k1"]),
            ("egcl_allpairs_f32_blocks_fwd_lj561", "fwd_561", 365,
             lj147f["k1_561"]),
            ("egcl_allpairs_f32_blocks_bwd_params", "bwd_params", 414,
             lj147f["k2_params"]),
            ("egcl_allpairs_f32_blocks_bwd", "bwd_blocks", 414,
             lj147f["k2_blocks"]),
            ("egcl_allpairs_f32_bwd_lj147", "bwd", 414, lj147f["k2"])):
        r = lj147f["rec"][key]
        kernels.append(kernel_record(name, "egcl_allpairs_f32.cu",
                                     f"{v3}:{line}", n, r["err"], r["ms"],
                                     r["plain"], r["bound"]))
    # the bf16 block pairs with streamed weights at H=256, N=55, each at
    # the batch of phase wide's run that launched it: K1 and K2 p of the VI
    # (B=256), K1 and K2 of the SMC run (B=1024)
    for name, direction, B, line, n in (
            ("egcl_allpairs_wide_fwd", "fwd", WIDE_B[0], 365, wide["k1"]),
            ("egcl_allpairs_wide_fwd_smc", "fwd", WIDE_B[1], 365,
             wide["k1_smc"]),
            ("egcl_allpairs_wide_bwd", "bwd", WIDE_B[1], 414, wide["k2"]),
            ("egcl_allpairs_wide_bwd_params", "bwd_params", WIDE_B[0], 414,
             wide["k2_params"])):
        r = wide["rec"][(direction, B)]
        kernels.append(kernel_record(name, "egcl_allpairs_sm90.cu",
                                     f"{v3}:{line}", n, r["err"], r["ms"],
                                     r["plain"], r["bound"]))
    # the f32 block pairs with streamed weights at H=256, N=22 (nf=4), each
    # at the batch of phase wide_f32's run that launched it: K1 and K2 p of
    # the VI (B=256), K1 and K2 of the SMC run (B=2048)
    for name, direction, sname, line, n in (
            ("egcl_allpairs_f32_wide_fwd", "fwd", "vi_ala2", 365, wf["k1"]),
            ("egcl_allpairs_f32_wide_fwd_smc", "fwd", "sample_ala2", 365,
             wf["k1_smc"]),
            ("egcl_allpairs_f32_wide_bwd", "bwd", "sample_ala2", 414,
             wf["k2"]),
            ("egcl_allpairs_f32_wide_bwd_params", "bwd_params", "vi_ala2",
             414, wf["k2_params"])):
        r = wf["rec"][(direction, WIDE_F32_H, sname)]
        kernels.append(kernel_record(name, "egcl_allpairs_f32.cu",
                                     f"{v3}:{line}", n, r["err"], r["ms"],
                                     r["plain"], r["bound"]))
    # the wide-nf routes at the reference's shapes (N=13), each with the
    # launches of phase wide_nf's driver run at that shape: bf16 K1 / K2 at
    # B=1024 of the node_nf 128 and 256 SMC runs, K2 p at B=512 of the bf16
    # VI at node_nf 128; f32 K1 / K2 p at B=512 of the f32 VI, K2 at B=256
    # of the f32 SMC run
    nrec, npaths = wn["rec"], wn["paths"]
    for name, key, dname, kind, line, n in (
            ("egcl_allpairs_wide_nf_fwd", "ref256", "bfloat16", "fwd", 365,
             npaths["smc256"]["launches"]["fwd_wide_nf_launches"]),
            ("egcl_allpairs_wide_nf_bwd", "ref256", "bfloat16", "bwd", 414,
             npaths["smc256"]["launches"]["bwd_wide_nf_launches"]),
            ("egcl_allpairs_wide_nf_fwd_128", "ref128", "bfloat16", "fwd",
             365, npaths["smc128"]["launches"]["fwd_wide_nf_launches"]),
            ("egcl_allpairs_wide_nf_bwd_128", "ref128", "bfloat16", "bwd",
             414, npaths["smc128"]["launches"]["bwd_wide_nf_launches"]),
            ("egcl_allpairs_wide_nf_bwd_params", "ref128", "bfloat16",
             "bwd_params", 414, npaths["vi_bfloat16"]["launches"][
                 "bwd_param_wide_nf_launches"]),
            ("egcl_allpairs_f32_wide_nf_fwd", "vi512", "float32", "fwd", 365,
             npaths["vi_float32"]["launches"]["fwd_f32_wide_nf_launches"]),
            ("egcl_allpairs_f32_wide_nf_bwd_params", "ref128", "float32",
             "bwd_params", 414, npaths["vi_float32"]["launches"][
                 "bwd_param_f32_wide_nf_launches"]),
            ("egcl_allpairs_f32_wide_nf_bwd", "smc256", "float32", "bwd",
             414, npaths["smc_f32"]["launches"]["bwd_f32_wide_nf_launches"])):
        r = nrec[(key, dname, kind)]
        src = "egcl_allpairs_sm90.cu" if dname == "bfloat16" else \
            "egcl_allpairs_f32.cu"
        kernels.append(kernel_record(name, src, f"{v3}:{line}", n, r["err"],
                                     r["ms"], r["plain"], r["bound"]))
    # the column-chunked kernels past H = 256 at hidden_nf XWIDE_H, each with
    # the launches of phase xwide's driver run at that shape: bf16 K1 / K2
    # at B=1024, N=13 of the LJ13 SMC run, K1 / K2 p at B=512 of the
    # vi_lj13 run; f32 K1 / K2 p at vi_ala2's B=256, N=22 of its run, K1 /
    # K2 at sample_ala2's B=2048 of the SMC run from its checkpoint
    xrec, xpaths = xw["rec"], xw["paths"]
    for name, key, dname, kind, line, n in (
            ("egcl_allpairs_xwide_fwd", "ref512", "bfloat16", "fwd", 365,
             xpaths["smc"]["launches"]["fwd_xwide_launches"]),
            ("egcl_allpairs_xwide_bwd", "ref512", "bfloat16", "bwd", 414,
             xpaths["smc"]["launches"]["bwd_xwide_launches"]),
            ("egcl_allpairs_xwide_fwd_vi", "vi512", "bfloat16", "fwd", 365,
             xpaths["vi_bfloat16"]["launches"]["fwd_xwide_launches"]),
            ("egcl_allpairs_xwide_bwd_params", "vi512", "bfloat16",
             "bwd_params", 414, xpaths["vi_bfloat16"]["launches"][
                 "bwd_param_xwide_launches"]),
            ("egcl_allpairs_f32_xwide_fwd", "vi_ala2", "float32", "fwd", 365,
             xpaths["vi_float32"]["launches"]["fwd_f32_xwide_launches"]),
            ("egcl_allpairs_f32_xwide_bwd_params", "vi_ala2", "float32",
             "bwd_params", 414, xpaths["vi_float32"]["launches"][
                 "bwd_param_f32_xwide_launches"]),
            ("egcl_allpairs_f32_xwide_fwd_smc", "sample_ala2", "float32",
             "fwd", 365, xpaths["smc_float32"]["launches"][
                 "fwd_f32_xwide_launches"]),
            ("egcl_allpairs_f32_xwide_bwd", "sample_ala2", "float32", "bwd",
             414, xpaths["smc_float32"]["launches"][
                 "bwd_f32_xwide_launches"])):
        r = xrec[(key, dname, kind)]
        kernels.append(kernel_record(name, "egcl_allpairs_xwide.cu",
                                     f"{v3}:{line}", n, r["err"], r["ms"],
                                     r["plain"], r["bound"]))
    # bf16 K5/K6 at 17 edge features (the Hopper kernels, two k16 steps of
    # e W1), with the launches of phase edge's node_nf 8 driver path
    c17, nf8 = erec[("c17", "bfloat16")], erec["nf8"]
    for name, d, line in (("fwd", "fwd", 219), ("bwd", "bwd", 246)):
        k = "k5" if d == "fwd" else "k6"
        kernels.append(kernel_record(
            f"edge_pipeline_{name}_c17", "edge_pipeline_sm90.cu",
            f"enflow_tpu/ops/edge_kernel.py:{line}",
            nf8["vi"][k] + nf8["smc"][k], c17[f"err_{d}"], c17[f"ms_{d}"],
            c17[f"plain_{d}"], c17[f"bound_{d}"]))
    # the streamed K5/K6 at H=256: f32 at the training shape with the
    # launches of phase edge_wide's train.yaml run (its resumed epoch
    # included), bf16 at the top-k SMC run's shape with that run's (the
    # top-k VI's, at 512 particles, are not in the line)
    wrec, wpaths = ew["rec"], ew["paths"]
    ek = "enflow_tpu/ops/edge_kernel.py"
    for name, key, src, n in (
            ("edge_pipeline_f32_wide", ("train", "float32", EDGE_WIDE_H),
             "edge_pipeline.cu",
             [a + b for a, b in zip(wpaths["train"]["launches"],
                                    wpaths["train"]["resumed"])]),
            ("edge_pipeline_wide", ("topk", "bfloat16", EDGE_WIDE_H),
             "edge_pipeline_sm90.cu", wpaths["smc"]["launches"])):
        r = wrec[key]
        for k, (d, line) in enumerate((("fwd", 219), ("bwd", 246))):
            kernels.append(kernel_record(
                f"{name}_{d}", src, f"{ek}:{line}", n[k], r[f"err_{d}"],
                r[f"ms_{d}"], r[f"plain_{d}"], r[f"bound_{d}"]))
    # the column-chunked K5/K6 at hidden_nf EDGE_XWIDE_H: f32 at the
    # training shape with the launches of phase edge_xwide's train.yaml run
    # (its resumed epoch included), bf16 at the top-k shape with those of
    # its top-k SMC run (1024 particles, 4 temps)
    xrec, xpaths = ex["rec"], ex["paths"]
    for name, key, n in (
            ("edge_pipeline_f32_xwide", ("train", "float32"),
             [a + b for a, b in zip(xpaths["train"]["launches"],
                                    xpaths["train"]["resumed"])]),
            ("edge_pipeline_xwide", ("topk", "bfloat16"),
             xpaths["smc"]["launches"])):
        r = xrec[key]
        for k, (d, line) in enumerate((("fwd", 219), ("bwd", 246))):
            kernels.append(kernel_record(
                f"{name}_{d}", "edge_pipeline_xwide.cu", f"{ek}:{line}", n[k],
                r["err"], r[f"ms_{d}"], r[f"plain_{d}"], r[f"bound_{d}"]))
    phase("done", f"all phases in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
