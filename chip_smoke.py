#!/usr/bin/env python
"""Smoke test of pycsou_tpu_torch on one CUDA card (an H100).

    python3 chip_smoke.py

1. Prints the card (``nvidia-smi`` name and power limit), the torch and
   CUDA versions, and the time to build the CUDA kernels from
   ``pycsou_tpu_torch/csrc``.
2. Runs every kernel of the port (K1-K8 and K10-K13 at 4096 x 4096, K9
   at 2048 x 2048) with the benchmark's 15 x 15 Gaussian PSF and its
   rank-2 PSF and its 70% keep mask (K10 and K11 also with the identity
   1 x 1 PSF), against the plain PyTorch version on the same inputs: max
   abs / rel error against the stated tolerance, median CUDA-event times of
   kernel and plain, each kernel's bound (its image streams over 3.35 TB/s
   or its float32 operations over 67 TFLOP/s, the larger), K1's one-call
   PyTorch counterpart (``F.conv2d``), K12's outside ``w`` pass, and the
   device-to-device copy of the kernels' image streams (their floor).
3. Drives the main path through the user's entry point, the README's
   ``PDS`` expression at 4096 x 4096 on the benchmark's problem, with the
   launch counters zeroed just before it and read just after: it must
   fuse onto ``TVDeconvolution`` with the engine ladder's pick (mega3 for
   the Gaussian PSF), launch K1 for ``A^H y`` and that engine's kernel once
   per step (K10: one launch per two iterations), and nothing else.  On a
   piecewise-constant image with the same blur and noise it must recover x
   better than the blurred observation.  The same expression with the
   rank-2 PSF must fuse onto megar (K1 2, K4 once per iteration), recover
   its image and agree with the generic chain after 6 iterations.  Every
   conv-mode engine asked for
   by name (megar K4, mega3 K10, mega2 K11, mega K12, sweep K2 + K3,
   element K2 + K13) and the generic chain (``fuse=False``, K2), each
   counted on its own, must agree with megar after 6 iterations.  Small
   denoising at 1024 x 1024 must run the ladder's pick in conv mode; the
   rank-2 PSF must be refused by ``stencil="mega3"``.
4. Drives the masked paths at 4096 x 4096 the same way, each counted on
   its own run: inpainting (``SquaredL2Loss * Masking``) and zero-fill
   super-resolution (``* DownSampling``) fused onto
   ``TVDeconvolution[sweepm2]`` (K6, one launch per two iterations, nothing
   else), blurred super-resolution (``* (Masking * Convolve2D)``) fused
   onto ``[megarm]`` (K7 once per iteration, K1 for ``A^H y`` only), and
   large denoising by ``PDS`` and by ``CPS`` (K6).  Each must recover the
   piecewise-constant image better than its observation.  Cross-checks:
   sweepm2 against sweepm (K5) and the generic chain, megarm against the
   generic chain.
5. Drives the LASSO path at 4096 x 4096: ``APGD(F=SquaredL2Loss(y) *
   Convolve2D(h), G=0.01 * L1Norm)`` on the benchmark's problem must fuse
   onto ``LassoDeconvolution[megaf]`` and launch K8 once per iteration and
   K1 only for ``A^H y``; the generic chain (``fuse=False``, K2) must agree
   after 5 iterations; on a sparse-spike image with the same blur and noise
   the recovery must beat the observation after 100 iterations.
6. Drives the PSFs outside the band gate at 4096 x 4096, each through
   ``PDS`` fusion and ``TVDeconvolution`` directly with the counters
   zeroed: bench.py's rank-6 PSF (``'bandg'``: ``TVDeconvolution[sweep]``
   on the grouped K1 sweeps, K1 4 times and K3 once an iteration), a
   17 x 17 full-rank PSF of bench.py's kind (rank 17: the FFT Gram
   ``ConvGram2D`` on its wrap path, K3 once an iteration, no K1) and
   bench.py's 15 x 15 full-rank PSF (rank 15: ``'bandg'`` in four groups,
   K1 8 times and K3 once).  Each must recover a piecewise-constant image
   better than its observation and agree after 5 iterations with the same
   solver on a second route to its Gram (the FFT Gram; the padded FFT
   Gram).  The full-rank LASSO (``APGD`` -> ``LassoDeconvolution[gram]``
   with ``ConvGram2D``, no kernel) must recover sparse spikes and agree
   with the generic chain.  K1 at rank 4 (a ``'bandg'`` group) against its
   plain version and its bound; one Gram apply of each route (``ConvGram2D``
   wrap and padded, ``A^H (A x)`` over ``torch.fft``, the ``'bandg'``
   compositions), device and host ms.
7. Drives the PMYULA path at 2048 x 2048 (the benchmark's sampler: seed 3,
   burn-in 20, ``G = 0.01 * L1Norm``): it must run the ``megal`` engine and
   launch K9 once per sample and K1 only for ``A^H y``; the generic chain
   (``use_pallas=False``, K2, the same Philox noise) must agree after 6
   samples; the MMSE's mean must come within 0.02 of the truth's.  K9's
   in-kernel noise must have standard normal moments at 2048 x 2048.
8. Drives ``DistributedTVDeconv2D`` on a mesh of four row shards of
   4096 x 4096 on one card (``make_mesh((4,), devices=[cuda:0] * 4)``,
   1024 rows a shard).  First K14 (mega2 on a shard, the Gaussian PSF),
   K15 (megar on a shard, the rank-2 PSF) and K16 (sweep on a shard) on the
   first, a middle and the last shard of a 4096 x 4096 state with the halos
   cut from it, against their plain versions (times per shard launch, and
   each bound from the shard's streams), and each on a one-shard mesh (the
   whole image, zero halos) against K11 (bit for bit), K4 and K3.  Then the
   three engines, each built and run for 100 iterations on its own with the counters
   zeroed: the Gaussian PSF on megasp (K1 four times for the shards'
   ``A^H y``, K14 four times an iteration), the rank-2 PSF on megarsp (K1
   four, K15 four an iteration), the 70% keep mask on sweepsp (K16 four an
   iteration); each must recover a piecewise-constant image better than its
   observation and agree after 6 iterations with ``TVDeconvolution`` on
   mega2, megar and sweepm given the same tau and sigma.
9. Drives ``Spatial2DTVDeconv2D`` on a 2-D ``(sp0, sp1)`` mesh of one
   card.  First K17 (megar on a block of a 2-D mesh) on blocks (0, 0),
   (0, 2), (2, 2) and (3, 3) of a (4, 4) mesh and on the four blocks of a
   (2, 2) mesh of a 4096 x 4096 state, halos from the exchange, with both
   PSFs, against its plain version (times per block launch, each bound from
   the block's own streams), and on a one-block mesh (zero halos) against
   K4; K18 (``sepgram_apply``, ``A^H A x``) at 4096 x 4096 on both PSFs
   against its plain version and K2 without ``atb``.  Then the path at
   4096 x 4096 on the (2, 2) mesh of four 2048 x 2048 blocks, the Gaussian
   and the rank-2 PSF, each built and run for 100 iterations with the
   counters zeroed (K1 four times for the blocks' ``A^H y``, K17 four
   times an iteration, nothing else), each recovering a piecewise-constant
   image better than its observation and agreeing after 6 iterations with
   ``TVDeconvolution[megar]`` given the same tau and sigma; a (4, 1) mesh
   (the row-shard kernel K15) and a (1, 4) mesh (K17 with zero row halos),
   each counted and held to megar after 6 iterations.
10. The slope-timed iterations/s of the main path (both PSFs), of the
    inpainting, blurred super-resolution, denoising and LASSO paths, of
    the other PSFs' paths and their second Gram routes, of the full-rank
    LASSO, of the generic chain, of the megar, mega3, mega2, mega and
    element engines, of the three sharded paths and of the two 2-D mesh
    paths at 4096 x 4096, the device-idle share of sharded megasp, of the
    2-D mesh path (Gaussian PSF), of the megar, mega2 and mega engines, of
    the inpainting and denoising paths (sweepm2, K6), of the other PSFs'
    PDS paths and of the full-rank LASSO from ``torch.profiler`` traces,
    the PMYULA samples/s, and the main path's ``solve()`` time to a 1e-6
    relative improvement.

11. Drives the stacked operators and spectral estimates, each run counted
    on its own: bench.py's cfg4 (``LinOpVStack([Masking, DCTOperator])``
    with the keep mask ``default_rng(4).random < 0.3``,
    ``compute_lipschitz_cst(maxiter=30)``, ``APGD`` with ``0.02 *
    L1Norm``) at 512 x 512 and 4096 x 4096: ``||A||`` within 1e-5 of
    sqrt(2) (``A^H A = diag(mask) + I``), no kernel of the port launched,
    the 512^2 run's ``||A||`` and iterates after 20 iterations against the
    port's CPU run, ``solve()``'s recovery within 5% of the spikes, the
    slope-timed iters/s, the power iteration's wall ms and host reads, and
    each size's device-idle share; a ``PDS`` whose ``K`` is the main
    path's 4096^2 Gaussian ``Convolve2D`` with an unknown ``||K||``: K1
    twice a Gram apply of its power iteration, ``||K|| <= 1 + 1e-5``, 20
    iterations (K1 40), and at 512^2 the card's estimate against the CPU's;
    ``lanczos_eigs`` and ``smallest_eig_psd`` (fold, shift-invert) of a
    4096^2 ``DiagonalOperator`` of known spectrum; ``opnorm``,
    ``singularvals``, ``cond`` and the Gram's ``eigenvals`` of a 4096 x 4096
    ``DenseOperator`` against ``torch.linalg.svdvals``; 30 new operators
    (derivatives, stacks, Kronecker, transforms, dense, sparse, diagonal,
    polynomial) at 1024^2 against their CPU run and their adjoint identity;
    ``todense`` of 1024 x 1024 matrices (the DCT's, by vmapped batches; a
    band ``Convolve2D``'s, a K1 launch a column) against the CPU's, and the
    pinv of an invertible 1024^2 x 1024^2 Kronecker product, each timed.
12. Drives the 1-D, N-D and circular convolutions and consensus ADMM, each
    run counted on its own: bench.py's cfg1 (``APGD`` on a 256-sample
    ``Convolve1D`` LASSO, no kernel) to 1e-6, its warm wall time and
    ``converged_at`` beside bench.py's numpy FISTA twin for as many
    iterations and the card's dispatch floor (one trivial launch and one
    host read), its slope-timed iters/s and device-idle share, and its
    iterates after 20 iterations against the port's CPU run; ``Convolve1D``
    on 2^20 samples with a 65-tap Gaussian on ``"auto"`` ('overlap-add')
    and on 'fft' (agreement, adjoint identity, apply / adjoint / Gram ms)
    and the ``APGD`` LASSO on it (iters/s, idle share); ``ConvolveND`` at
    256^3 with a 7^3 Gaussian (``SeparableConvGramND``, also against
    ``ConvGramND``) and a 5^3 draw (``ConvGramND``), each Gram against
    ``adjoint(apply(x))``; ``MovingAverage2D((4096, 4096), (5, 5))``: K1
    once an apply and once an adjoint, against K1's plain version;
    ``CircularConvolve`` at 256^3: the pinv's residual; bench.py's cfg5
    (``ConsensusADMM``, Fourier backend, 4 scenarios, rho 1, the default
    mesh) at 64^3 against the CPU after 20 iterations and bench.py's numpy
    twin, and at 256^3, each slope-timed with its idle share; the ADMM CG
    backend on four band ``Convolve2D``s at 1024^2 (``NonNegativeOrthant``,
    10 iterations): K1 once a scenario a step and twice a row for each
    counted CG apply, recovery better than the first observation.  Its
    record is printed as ``{"conv_admm": ..., "card": ...}`` on a line of
    its own after the phase.
13. Drives the proximal calculus and the sampling operators, each run
    counted on its own: Poisson-TV deblurring at 4096 x 4096 (the peaks
    image, ``y = Poisson(A x_true)``, ``PDS`` with ``H =
    ProxFuncHStack([KLDivergence(y), 0.5 * L21Norm])`` and ``K =
    LinOpVStack([A, Gradient])``, started at the observation: K1 twice an
    iteration, the generic chain), robust deblurring (``H = L1Loss(y)``,
    ``K = A``, 5% salt: K1 twice an iteration) and the group LASSO
    (``APGD`` with ``0.01 * L21Norm(groups=8 x 8 tiles)``: K2 once an
    iteration, K1 for ``A^H y``), each recovering better than its
    observation after 200 (100) iterations, slope-timed with its idle
    share, Poisson-TV and the group LASSO against the CPU at 1024 x 1024
    after 20 iterations; every new prox, projection and apply at 4096 x
    4096 (a complex64 image for ``L1Norm.prox`` and ``SquaredL2Norm``)
    against the CPU, device-timed, and run under
    ``torch.cuda.set_sync_debug_mode("error")``; ``Pooling`` at 4096 x 4096,
    ``NNSampling`` of 2^18 samples on a 512 x 512 grid (both adjoint
    modes; cut from 2^20 on 1024 x 1024, where the host KD-tree took
    4.3 s) and the degree-15 ``GeneralisedVandermonde`` at 2^20 samples
    (apply and adjoint ms, adjoint identity, against the CPU); the two
    problems of ``examples/rbf_interpolation.py`` (``main()``'s fit error
    against the CPU's; ``main_large()``'s 50,000-point sparse ``APGD``:
    kmax, iters/s, 20 iterations against the CPU, a matvec against the
    matrix-free backend).  Its record is the ``{"prox_sampling": ...}``
    line after phase 12's.
14. Drives the solver's checkpoint, objective, iterates and profiling on
    the main path at 4096 x 4096 (``PDS`` -> mega3): a solve stopped at
    200 iterations with ``checkpoint_dir`` (``build/phase14``, removed
    after) and resumed by a fresh solver to 400 must equal one
    uninterrupted 400-iteration solve bit for bit (one save's and one
    load's seconds); ``track_objective``'s rate against the plain one, its
    ``run_fixed(100)`` under ``set_sync_debug_mode("error")``, its last
    entry against ``objective(x)``; ``iterates(100, stride=20)`` against
    ``run_fixed(20 k)``; ``utils.profiling.trace`` of 20 iterations inside
    ``annotate("phase14")`` naming K10 and the span, ``device_time``.  Then
    the sharded chain on four 1024-row shards of one card, each built and
    run for 20 iterations with the counters zeroed and held to
    ``TVDeconvolution`` on one device with the same steps: a 17 x 17
    full-rank PSF on sweepsp over the sharded FFT Gram (K16 80, nothing
    else; K16's shard time on this path), the Gaussian on the band chain
    and the keep mask on the diagonal chain (``use_pallas=False``, no
    launch), the mask on a (2, 2) 2-D mesh of 2048 x 2048 blocks, and
    ``BatchedDistributedTVDeconv2D`` with two 4096 x 4096 images on a
    (2, 2) ``(dp, sp)`` mesh, each slope-timed with its idle share; the
    full-rank case and the batch against the CPU at 1024 x 1024.  Its
    record is the ``{"solver_io_chain": ...}`` line after phase 13's;
    ``python3 chip_smoke.py --phase 14`` runs it alone.
15. Drives the sharded entry points at 4096 x 4096 on one card, each run
    counted on its own: ``PDS(...).with_shardings(x=shard_along(mesh, "sp",
    2, 0))`` on four row shards routes the main path onto
    ``DistributedTVDeconv2D[megasp]`` (K14 80 in 20 iterations, K1 4), the
    rank-2 PSF onto megarsp (K15 80, K1 4) and inpainting onto sweepsp (K16
    80), and ``PartitionSpec("sp0", "sp1")`` on a (2, 2) mesh the main path
    onto ``Spatial2DTVDeconv2D[megar2d]`` (K17 80, K1 4): each routed x bit
    for bit the hand-built solver's and within 1e-4 of ``TVDeconvolution``
    on one device; tau != sigma and a combined-mode problem decline to the
    generic chain with a warning and no shard kernel, and a constructor's
    ``RuntimeError`` (patched in) propagates; ``TVDeconvolution``'s sharded
    copy runs mega2 (K11 21 in ``run_fixed(21)``, bit for bit; the rank-2
    PSF's megar, K4 21), PMYULA's at
    2048^2 and the LASSO ``APGD``'s launch no K9 and no K8 and agree with
    the fused engines; ``ShardedDenseOperator`` at 16384^2 (rows,
    ``from_blocks``, a (2, 2) mesh) against ``torch.matmul``, slope-timed
    beside its bound; ``ShardedBlockDiagonalOperator`` of 8 band
    ``Convolve2D`` blocks of 1024^2 (K1 8 an apply); ``PencilCircularConv2D``
    at 4096^2 against ``CircularConvolve`` (apply, adjoint, gram, pinv, the
    dot test, device and host ms) and a circular deconvolution by
    ``APGD.with_shardings`` over it; ``distributed_init()`` of one process;
    the routed and hand-built rates alternately, with the routed idle
    share.  Its record is the ``{"sharded_entry": ...}`` line after phase
    14's; ``python3 chip_smoke.py --phase 15`` runs it alone.
16. Drives the sharded solvers and operators on a mesh that spans two
    processes on the card.  The parent runs each case on a one-process
    mesh of four positions of ``cuda:0`` (K14-K17 80 launches in 20
    iterations), then starts two worker processes
    (``--phase16-worker``) joined by ``distributed_init(...,
    backend="gloo")`` (CUDA tensors through pinned host buffers: NCCL
    refuses two ranks on one card), each driving two of the positions at
    4096 x 4096: megasp (Gaussian PSF), megarsp (rank-2 PSF), sweepsp
    (inpainting), ``Spatial2DTVDeconv2D`` on (2, 2) with the process
    boundary along the rows and then along the columns, cfg5-style
    ``ConsensusADMM`` (4 scenarios at 128^3), ``ShardedDenseOperator`` at
    16384^2 (``from_blocks``: each process draws its own blocks) and
    ``PencilCircularConv2D``.  Each worker's joined x and z (ADMM's z and
    u) must hash as the parent's (bit for bit), K14-K17 launch exactly 2
    times a worker an iteration (40 in ``run_fixed(20)``), the operators
    agree within 1e-6; each worker reports its iters/s, device-idle share
    and the bytes it sent an iteration.  A worker that fails or times out
    fails the script.  Its record is the ``{"multiprocess": ...}`` line
    after phase 15's; ``python3 chip_smoke.py --phase 16`` runs it alone.
17. Runs the ten ``examples/torch`` twins' ``main()`` (and
    ``rbf_interpolation.main_large``) at the reference examples' sizes on
    the card (the bayes twin cut to 1,000 samples: ``P17_ARGS``), each
    counted on its own: each quality figure (PSNR, relative error) must
    beat its observation's, and the fused examples must run
    their engine and launch exactly its kernels: ``deconv_tv_2048``
    mega3 (K10, and K1 for ``y = A x`` and ``A^H y``), ``motion_deblur_rank2``
    megar (K4 and K1), ``inpainting_tv`` sweepm2 (K6 alone).  Then
    ``pycsou_tpu_torch.entry``: ``entry()``'s step must launch K10 once and
    equal ``TVDeconvolution``'s step on the same state within 1e-6, and
    ``dryrun_multichip(4)`` on four positions of the card must run its 12
    paths (K14-K17 among their launches).  One line an example gives its
    seconds and figure beside the card.  Its record is the
    ``{"examples": ...}`` line after phase 16's; ``python3 chip_smoke.py
    --phase 17`` runs it alone.

``python3 chip_smoke.py --gram-ab OLD_ROOT`` instead times, for the
checkout at OLD_ROOT and for this one in turns (old, new, new, old), each
run a process of its own on the same card: the callers of the shared Gram
(``csrc/sepconv.cuh``: K1, K2, K18, K4, K7, K8, K9, K15, K17) on both
PSFs, K10 on the Gaussian and the identity PSF, K11 on both, K12 on the
Gaussian PSF, K3 as a control, the 1-D shard kernels K14 and K16 on a
middle shard, K6 with the keep mask and K5 as its control, the rates of
the paths they carry (the main path on mega3, mega2, mega and megar by
name, small denoising at 1024 x 1024, the sharded megasp, megarsp and
sweepsp paths, inpainting and ``PDS`` denoising on K6 among them) and the
main path's time to 1e-6.  ``--gram-times ROOT
[--kernels-only]`` is one such run.

Any failure exits non-zero.  On success the last two lines are a JSON
object with the per-kernel results and the device line
``{"ok": true, "device": {...}}``.  In the results, ``kernels`` holds
K1-K18, each with the launches of the run named in ``run``, counted with
every counter zeroed just before that run (``RUN_OF``: the rank-6 PSF's
``PDS`` for K1, the README's path for the ladder's engine, the same path
with the rank-2 PSF for K4, inpainting for K6, blurred
super-resolution for K7, the LASSO path for K8, the PMYULA path for K9,
the sharded paths for K14-K16, the 2-D mesh path for K17, the direct
``sepgram_apply`` calls for K18, which no path of the package calls, and
for the kernels no fused main path runs, the run that goes through each),
its ``bound_ms`` and ``bound_by``, and ``library_ms`` (K1's
``F.conv2d``; null where no one PyTorch call computes the kernel's
function).  ``spectral`` holds phase 11's results and its seconds; phase
12's are on the ``conv_admm`` line before, phase 13's on the
``prox_sampling`` line, phase 14's on the ``solver_io_chain`` line (K16's
entry adds its launches and shard time on phase 14's FFT-Gram path),
phase 15's on the ``sharded_entry`` line (K14-K17's entries add their
launches on the routed paths, K11's and K4's under ``TVDeconvolution.with_shardings``
and K1's in one ``ShardedBlockDiagonalOperator`` apply), phase 16's on
the ``multiprocess`` line (K14-K17's entries add each worker's launches
across processes, K1's each worker's ``A^H y`` launches), phase 17's on
the ``examples`` line.
Without CUDA it exits 2 and prints no result.
"""
import functools
import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

SHAPE = (4096, 4096)
KSIZE = 15
LAM = 0.05
SEED = 0
ITERS = 100
# kernels vs plain versions: f32 sums in another order; the error bound is
# relative to the larger of 1 and the largest magnitude of the result
TOL_REL = 1e-5
TOL_STATS = 1e-5  # metric partial sums (per-block f32, folded in f64)
TOL_PATH = 1e-4  # iterates of two engines after a few iterations

KERNELS = {
    "K1": ("sepconv2d", "pycsou_tpu_torch/csrc/conv2d.cu", "pycsou_tpu/kernels/conv2d.py:273"),
    "K2": ("sepgram2d", "pycsou_tpu_torch/csrc/conv2d.cu", "pycsou_tpu/kernels/conv2d.py:391"),
    "K3": ("tv_pds_sweep_step_stats", "pycsou_tpu_torch/csrc/tv.cu", "pycsou_tpu/kernels/tv.py:395"),
    "K4": ("tv_pds_megar_step", "pycsou_tpu_torch/csrc/tvr.cu", "pycsou_tpu/kernels/tvr.py:352"),
    "K5": ("tv_pds_sweepm_step_stats", "pycsou_tpu_torch/csrc/tv.cu", "pycsou_tpu/kernels/tv.py:476"),
    "K6": ("tv_pds_sweepm2_step", "pycsou_tpu_torch/csrc/tvm2.cu", "pycsou_tpu/kernels/tv.py:623"),
    "K7": ("tv_pds_megarm_step", "pycsou_tpu_torch/csrc/tvr.cu", "pycsou_tpu/kernels/tvr.py:352"),
    "K8": ("lasso_fista_step", "pycsou_tpu_torch/csrc/fista.cu", "pycsou_tpu/kernels/fista.py:163"),
    "K9": ("pmyula_mega_step", "pycsou_tpu_torch/csrc/langevin.cu", "pycsou_tpu/kernels/langevin.py:151"),
    "K10": ("tv_pds_mega3_step", "pycsou_tpu_torch/csrc/tvr1.cu", "pycsou_tpu/kernels/tv.py:1637"),
    "K11": ("tv_pds_mega2_step", "pycsou_tpu_torch/csrc/tvr1.cu", "pycsou_tpu/kernels/tv.py:1386"),
    "K12": ("tv_pds_mega_step", "pycsou_tpu_torch/csrc/tvr1.cu", "pycsou_tpu/kernels/tv.py:844"),
    "K13": ("tv_pds_stencil_step", "pycsou_tpu_torch/csrc/tv.cu", "pycsou_tpu/kernels/tv.py:158"),
    "K14": ("tv_pds_mega2_shard_step", "pycsou_tpu_torch/csrc/tvr1.cu", "pycsou_tpu/kernels/tv.py:1417"),
    "K15": ("tv_pds_megar_shard_step", "pycsou_tpu_torch/csrc/tvr.cu", "pycsou_tpu/kernels/tvr.py:378"),
    "K16": ("tv_pds_sweep_shard_step", "pycsou_tpu_torch/csrc/tv.cu", "pycsou_tpu/kernels/tv.py:670"),
    "K17": ("tv_pds_megar_shard2d_step", "pycsou_tpu_torch/csrc/tvr.cu", "pycsou_tpu/kernels/tvr.py:411"),
    "K18": ("sepgram_apply", "pycsou_tpu_torch/csrc/conv2d.cu", "pycsou_tpu/kernels/sepgram.py:140"),
}
# the conv-mode engines -> the kernel each launches once per step (element
# also launches K2 for its gradient)
ENGINE_KERNEL = {"mega3": "K10", "mega2": "K11", "megar": "K4", "mega": "K12", "sweep": "K3",
                 "element": "K13"}
# each kernel -> the run that counts its launches: the README's PDS (the
# ladder's pick, TVDeconvolution[mega3]) runs K1 (A^H y) and K10, the same
# PDS with the rank-2 PSF [megar] K4,
# inpainting [sweepm2] K6, blurred super-resolution [megarm] K7, the LASSO
# path [megaf] K8, the PMYULA path [megal] K9; the kernels no fused main
# path runs go through the generic chain and the engines asked for by name
# (phase_main_path puts the ladder's pick under "main path")
RUN_OF = {"K1": "rank 6 PDS", "K2": "PDS fuse=False", "K3": "TVDeconvolution stencil='sweep'",
          "K4": "main path (rank-2 PSF)", "K5": "TVDeconvolution stencil='sweepm'",
          "K6": "inpainting", "K7": "blurred super-resolution", "K8": "LASSO", "K9": "PMYULA",
          "K10": "TVDeconvolution stencil='mega3'", "K11": "TVDeconvolution stencil='mega2'",
          "K12": "TVDeconvolution stencil='mega'", "K13": "TVDeconvolution stencil='element'",
          "K14": "sharded megasp", "K15": "sharded megarsp", "K16": "sharded sweepsp",
          "K17": "2-D mesh megar2d (gauss)", "K18": "sepgram_apply"}
# the least time of a kernel's work on an H100 SXM (NVIDIA's data sheet):
# its image streams over the memory rate, or its float32 operations over
# the float32 rate outside the tensor cores, whichever is larger
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
STENCIL_FLOPS = 40  # float32 operations of one stencil update per pixel (pds_stencil.cuh)
SHAPE_MCMC = (2048, 2048)  # bench.py sec_mcmc
SHARDS = 4  # the sharded paths' mesh: four row shards on one card
MESH2D = (2, 2)  # the 2-D mesh path's (sp0, sp1) mesh: four blocks on one card
LAM_L1 = 0.01  # bench.py sec_lasso and sec_mcmc
FULLRANK_FFT_K = 17  # taps of the full-rank PSF that runs the FFT Gram: rank 17, above 'bandg''s 16
# the stacked operators and spectral estimates
CFG4_SIZES = (512, 4096)  # bench.py sec_cfg4_stacked's 512^2, and the main path's image size
SHAPE_PI_CPU = (512, 512)  # the unknown-||K|| PDS's estimate held to the port's CPU run
SHAPE_OPS = (1024, 1024)  # the new operators against their CPU run
N_DENSE = 4096  # DenseOperator's eigenvals/singularvals/cond against torch.linalg.svdvals
TOL_SQRT2 = 1e-5  # cfg4's ||A|| against sqrt(2)
TOL_NORM_CPU = 1e-6  # cfg4's ||A||, card against CPU, relative
TOL_PI_CPU = 1e-5  # the unknown-||K|| estimate, card against CPU, relative
TOL_RECOVERY = 0.05  # cfg4's relative error of the recovered x after solve()
TOL_OPS = 1e-5  # an operator on the card against its CPU run, x max(1, max |out|)
TOL_ADJOINT = 1e-4  # |<A x, y> - <x, A^H y>| over ||A x|| ||y||
TOL_SPECTRUM = 1e-3  # an estimate against the exact spectrum (the CPU tests' against numpy)
SHAPE_DENSE = (32, 32)  # todense's images: 1024 x 1024 matrices
N_KRON = 1024  # the Kronecker pinv's factors, N_KRON x N_KRON with singular values in [1, 2]
TOL_PINV = 1e-4  # ||K pinv(y) - y|| over ||y|| for the invertible Kronecker product and CircularConvolve
N_1D = 2**20  # the 1-D convolution's samples: "auto" takes 'overlap-add' there
TAPS_1D = 65  # its Gaussian's taps (sigma 8)
SHAPE_3D = (256, 256, 256)  # ConvolveND and CircularConvolve
CFG5_SIZES = (64, 256)  # bench.py sec_cfg5_admm3d's 64^3 x 4 scenarios, and 256^3 for the device-bound rate
SHAPE_CG = (1024, 1024)  # the ADMM CG backend's band Convolve2Ds
CG_SIGMAS = (1.5, 2.0, 2.5, 3.0)  # its four scenarios' Gaussians
TOL_CPU = 1e-5  # cfg1's x and cfg5's z on the card against the CPU after 20 iterations, x max |CPU|
TOL_GRAM_ND = 1e-4  # an N-D Gram against adjoint(apply(x)), or the other Gram, over max |reference|


def log(*a):
    print(*a, flush=True)


def gaussian_kernel(k=KSIZE, sigma=2.0):
    ax = np.arange(k) - k // 2
    g = np.exp(-(ax**2) / (2 * sigma**2))
    g2 = np.outer(g, g)
    return (g2 / g2.sum()).astype(np.float32)


def rank2_kernel(k=KSIZE):
    ax = np.arange(k) - k // 2
    g = lambda s: np.exp(-(ax**2) / (2 * s**2))  # noqa: E731
    h2 = np.outer(g(2.0), g(2.0)) + 0.35 * np.outer(g(0.8), g(4.0))
    return (h2 / h2.sum()).astype(np.float32)


def make_problem(rng, shape=SHAPE):
    """The benchmark's problem (bench.py make_problem), with x_true kept:
    white |N(0, 1)| noise blurred by the Gaussian PSF, plus 0.01 noise."""
    from scipy.signal import fftconvolve

    h = gaussian_kernel()
    x_true = np.abs(rng.standard_normal(shape)).astype(np.float32)
    y = fftconvolve(x_true, h, mode="same").astype(np.float32)
    y += 0.01 * rng.standard_normal(shape).astype(np.float32)
    return h, x_true, y


def blocks_image(rng, shape=SHAPE, block=64):
    """A piecewise-constant image (64-pixel blocks of |N(0, 1)| levels), the
    kind of image a TV prior recovers."""
    levels = np.abs(rng.standard_normal((shape[0] // block, shape[1] // block)))
    return np.kron(levels, np.ones((block, block))).astype(np.float32)


def keep_mask(shape=SHAPE):
    """The benchmark's sampling mask (bench.py sec_inpaint): 70% kept."""
    return np.random.default_rng(13).random(shape) < 0.7


def blocks_problem(rng, h, shape=SHAPE, block=64):
    """The same blur and noise on the piecewise-constant image of
    :func:`blocks_image`.  White noise is no such image: there the TV
    solution's error stays about 0.5% above the observation's, to
    convergence."""
    from scipy.signal import fftconvolve

    x_true = blocks_image(rng, shape, block)
    y = fftconvolve(x_true, h, mode="same").astype(np.float32)
    y += 0.01 * rng.standard_normal(shape).astype(np.float32)
    return x_true, y


def median_ms(fn, reps=15, warmup=3):
    """Median CUDA-event time of one call of ``fn`` on the device.  The
    timed calls are queued behind a device sleep longer than their host
    time, so that each pair of events brackets the device's work and not
    the host's enqueue, which for a short kernel behind a Python wrapper is
    the longer of the two."""
    t0 = time.perf_counter()
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    host_s = (time.perf_counter() - t0) / warmup
    torch.cuda._sleep(int(2e9 * min(1.5 * reps * host_s + 1e-3, 1.0)))  # cycles, about 2 GHz
    events = []
    for _ in range(reps):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        events.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def host_ms(fn, n=200):
    """Host ms of one call of ``fn`` (wrapper and launches), ``n`` calls
    enqueued back to back: the device's queue takes them all, so that this
    is the host's time even where the device is slower."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e3 * host / n


def bound(streams, flops, shape=SHAPE):
    """``(bound_ms, bound_by)`` of a kernel moving ``streams`` images of
    ``shape`` (each read or written once) and doing ``flops`` float32
    operations."""
    t_bytes = streams * shape[0] * shape[1] * 4 / PEAK_BYTES_PER_S
    t_ops = flops / PEAK_F32_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def shard_rows(h, reach):
    """Rows of width W that a row-shard kernel must move for a core of ``h``
    rows when its data gradient reaches ``reach`` rows each side: x over the
    core grown by ``reach`` above and ``reach + 1`` below (the stencil reads
    the gradient a row down), atb (or g) and z1 over the core and the row
    below, z0 over the core and a row either side, the three outputs over
    the core."""
    return (h + 2 * reach + 1) + (h + 1) + (h + 2) + (h + 1) + 3 * h


def block_elems(h, w, reach_r, reach_c):
    """Floats a 2-D mesh block kernel must move for an (h, w) core when its
    data gradient reaches ``reach_r`` rows and ``reach_c`` columns each
    side: x over the core grown by the reach (one more below and right, the
    stencil reads the gradient there), atb over the core and the row and
    column after it, z0 over a row either side and the column after, z1
    over a column either side and the row after, the three outputs over the
    core."""
    return ((h + 2 * reach_r + 1) * (w + 2 * reach_c + 1) + (h + 1) * (w + 1) + (h + 2) * (w + 1)
            + (h + 1) * (w + 2) + 3 * h * w)


def max_err(got, want):
    """(max abs error, max abs error / max(1, max |want|))."""
    a = float((got - want).abs().max())
    return a, a / max(1.0, float(want.abs().max()))


def phase_kernels(dev, rng):
    from pycsou_tpu_torch.kernels.conv2d import (
        SepFactors, sepconv2d, sepconv2d_plain, sepgram2d, sepgram2d_plain,
    )
    from pycsou_tpu_torch.kernels.tv import (
        tv_pds_sweep_step_stats, tv_pds_sweep_step_stats_plain, tv_pds_sweepm2_step,
        tv_pds_sweepm2_step_plain, tv_pds_sweepm_step_stats, tv_pds_sweepm_step_stats_plain,
    )
    from pycsou_tpu_torch.kernels.tvr import (
        tv_pds_megar_step, tv_pds_megar_step_plain, tv_pds_megarm_step_plain,
    )
    from pycsou_tpu_torch.kernels.fista import lasso_fista_step, lasso_fista_step_plain
    from pycsou_tpu_torch.kernels.langevin import pmyula_mega_step, pmyula_mega_step_plain
    from pycsou_tpu_torch.kernels.band import gram_band_cols
    from pycsou_tpu_torch.kernels.tv import (
        tv_pds_mega2_step, tv_pds_mega2_step_plain, tv_pds_mega3_step, tv_pds_mega3_step_plain,
        tv_pds_mega_step, tv_pds_mega_step_plain, tv_pds_stencil_step, tv_pds_stencil_step_plain,
    )
    from pycsou_tpu_torch.ops import Convolve2D
    from pycsou_tpu_torch.ops.conv import lowrank_factors
    from pycsou_tpu_torch.utils.device import full_f32

    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)  # noqa: E731
    x = t(np.abs(rng.standard_normal(SHAPE)))
    atb = t(rng.standard_normal(SHAPE))
    z0 = t(0.01 * rng.standard_normal(SHAPE))
    z1 = t(0.01 * rng.standard_normal(SHAPE))
    m = t(keep_mask())
    matb = m * atb  # a back-projection vanishes where nothing was sampled
    kw = dict(tau=0.3, sigma=0.3, rho=0.9, lam=LAM, nonneg=True, iso=True)
    res = {k: {"max_abs_err": 0.0, "max_rel_err": 0.0} for k in KERNELS}

    def note(k, label, got, want, fn, plain_fn, psf):
        pairs = list(zip(got, want)) if isinstance(got, tuple) else [(got, want)]
        worst = (0.0, 0.0)  # this call's (abs, rel); res[k] keeps the kernel's maximum
        for i, (a, b) in enumerate(pairs):
            if b.ndim == 1:  # the metric partial sums
                rel = float(((a - b).abs() / b.abs().clamp(min=1e-30)).max())
                if rel > TOL_STATS:
                    raise AssertionError(f"{k} {label} stats rel err {rel:.3e} > {TOL_STATS}")
                continue
            ab, rel = max_err(a, b)
            worst = (max(worst[0], ab), max(worst[1], rel))
            res[k]["max_abs_err"] = max(res[k]["max_abs_err"], ab)
            res[k]["max_rel_err"] = max(res[k]["max_rel_err"], rel)
            if rel > TOL_REL:
                raise AssertionError(f"{k} {label} output {i}: err {ab:.3e} (rel {rel:.3e}) > {TOL_REL}")
        ms, pms = median_ms(fn), median_ms(plain_fn)
        log(f"  {k} {label:<12} {psf:<6} max abs err {worst[0]:.3e} "
            f"(rel {worst[1]:.3e}, tol {TOL_REL:g}); kernel {ms:.4f} ms, plain {pms:.4f} ms")
        return ms, pms

    for psf, h in (("gauss", gaussian_kernel()), ("rank2", rank2_kernel())):
        us, vs = lowrank_factors(h)
        f = SepFactors(us, vs, h.shape[0] // 2, h.shape[1] // 2, dev)
        a, a2 = f.adjoint(), f.adjoint(2.0)
        log(f"PSF {psf}: rank {f.rank}, {f.Ku}x{f.Kv} taps")
        times = {}
        times["K1"] = note("K1", "forward", sepconv2d(x, f), sepconv2d_plain(x, f),
                           lambda: sepconv2d(x, f), lambda: sepconv2d_plain(x, f), psf)
        note("K1", "adjoint", sepconv2d(x, a), sepconv2d_plain(x, a),
             lambda: sepconv2d(x, a), lambda: sepconv2d_plain(x, a), psf)
        note("K2", "gram", sepgram2d(x, f, a), sepgram2d_plain(x, f, a),
             lambda: sepgram2d(x, f, a), lambda: sepgram2d_plain(x, f, a), psf)
        times["K2"] = note("K2", "gradient", sepgram2d(x, f, a2, atb), sepgram2d_plain(x, f, a2, atb),
                           lambda: sepgram2d(x, f, a2, atb), lambda: sepgram2d_plain(x, f, a2, atb), psf)
        g = sepgram2d_plain(x, f, a2, atb)
        times["K3"] = note("K3", "step", tv_pds_sweep_step_stats(x, z0, z1, g, **kw),
                           tv_pds_sweep_step_stats_plain(x, z0, z1, g, **kw),
                           lambda: tv_pds_sweep_step_stats(x, z0, z1, g, **kw),
                           lambda: tv_pds_sweep_step_stats_plain(x, z0, z1, g, **kw), psf)
        times["K4"] = note("K4", "step", tv_pds_megar_step(x, z0, z1, atb, f, a2, **kw),
                           tv_pds_megar_step_plain(x, z0, z1, atb, f, a2, **kw),
                           lambda: tv_pds_megar_step(x, z0, z1, atb, f, a2, **kw),
                           lambda: tv_pds_megar_step_plain(x, z0, z1, atb, f, a2, **kw), psf)
        times["K7"] = note("K7", "step", tv_pds_megar_step(x, z0, z1, atb, f, a2, mask=m, **kw),
                           tv_pds_megarm_step_plain(x, z0, z1, m, atb, f, a2, **kw),
                           lambda: tv_pds_megar_step(x, z0, z1, atb, f, a2, mask=m, **kw),
                           lambda: tv_pds_megarm_step_plain(x, z0, z1, m, atb, f, a2, **kw), psf)
        for k, (ms, pms) in times.items():
            key = "" if psf == "gauss" else "rank2_"
            res[k][key + "ms"], res[k][key + "plain_ms"] = ms, pms
        # the one PyTorch call computing K1's function: the 2-D PSF, flipped
        # (F.conv2d correlates), as a cuDNN convolution in IEEE f32
        wt = torch.from_numpy(np.ascontiguousarray(h[::-1, ::-1])).to(dev)[None, None]

        def library_conv():
            with full_f32():
                return F.conv2d(x[None, None], wt, padding=KSIZE // 2)[0, 0]

        ab, rel = max_err(library_conv(), sepconv2d(x, f))
        if rel > TOL_REL:
            raise AssertionError(f"K1 against F.conv2d: rel err {rel:.3e}")
        key = "" if psf == "gauss" else "rank2_"
        res["K1"][key + "library_ms"] = median_ms(library_conv)
        log(f"  K1 library F.conv2d {psf:<6} {res['K1'][key + 'library_ms']:.4f} ms (rel err {rel:.3e} to K1)")
        taps = f.rank * (f.Ku + f.Kv)
        if psf == "gauss":
            res["K1"]["bound"] = bound(2, 2 * taps * SHAPE[0] * SHAPE[1])
            res["K2"]["bound"] = bound(3, (4 * taps + 2) * SHAPE[0] * SHAPE[1])
            res["K2"]["gram_bound"] = bound(2, 4 * taps * SHAPE[0] * SHAPE[1])  # A^H A x: no atb
            res["K3"]["bound"] = bound(7, STENCIL_FLOPS * SHAPE[0] * SHAPE[1])
            res["K4"]["bound"] = bound(7, (4 * taps + STENCIL_FLOPS) * SHAPE[0] * SHAPE[1])
            res["K7"]["bound"] = bound(8, (4 * taps + 1 + STENCIL_FLOPS) * SHAPE[0] * SHAPE[1])
        else:
            res["K1"]["rank2_bound"] = bound(2, 2 * taps * SHAPE[0] * SHAPE[1])
            res["K2"]["rank2_bound"] = bound(3, (4 * taps + 2) * SHAPE[0] * SHAPE[1])
            res["K4"]["rank2_bound"] = bound(7, (4 * taps + STENCIL_FLOPS) * SHAPE[0] * SHAPE[1])
    # the masked steps take no PSF
    res["K5"]["ms"], res["K5"]["plain_ms"] = note(
        "K5", "step", tv_pds_sweepm_step_stats(x, z0, z1, m, matb, **kw),
        tv_pds_sweepm_step_stats_plain(x, z0, z1, m, matb, **kw),
        lambda: tv_pds_sweepm_step_stats(x, z0, z1, m, matb, **kw),
        lambda: tv_pds_sweepm_step_stats_plain(x, z0, z1, m, matb, **kw), "-")
    res["K6"]["ms"], res["K6"]["plain_ms"] = note(
        "K6", "2 steps", tv_pds_sweepm2_step(x, z0, z1, m, matb, **kw),
        tv_pds_sweepm2_step_plain(x, z0, z1, m, matb, **kw),
        lambda: tv_pds_sweepm2_step(x, z0, z1, m, matb, **kw),
        lambda: tv_pds_sweepm2_step_plain(x, z0, z1, m, matb, **kw), "-")
    res["K5"]["bound"] = bound(8, (STENCIL_FLOPS + 3) * SHAPE[0] * SHAPE[1])
    res["K6"]["bound"] = bound(8, 2 * (STENCIL_FLOPS + 3) * SHAPE[0] * SHAPE[1])

    # K10-K13, the rank-1 engines: the Gaussian PSF and the identity (the
    # small-denoise route's 1 x 1 PSF); K10 against two plain K11 steps,
    # with the second one's stats
    zs = torch.stack([z0, z1])
    zs[0, -1] = 0.0
    zs[1, :, -1] = 0.0
    for psf, h in (("gauss", gaussian_kernel()), ("identity", np.ones((1, 1), np.float32))):
        gram = Convolve2D(SHAPE, h, device=dev).gram
        times = {}
        times["K10"] = note("K10", "2 steps", tv_pds_mega3_step(x, z0, z1, atb, gram, **kw),
                            tv_pds_mega3_step_plain(x, z0, z1, atb, gram, **kw),
                            lambda: tv_pds_mega3_step(x, z0, z1, atb, gram, **kw),
                            lambda: tv_pds_mega3_step_plain(x, z0, z1, atb, gram, **kw), psf)
        times["K11"] = note("K11", "step", tv_pds_mega2_step(x, z0, z1, atb, gram, **kw),
                            tv_pds_mega2_step_plain(x, z0, z1, atb, gram, **kw),
                            lambda: tv_pds_mega2_step(x, z0, z1, atb, gram, **kw),
                            lambda: tv_pds_mega2_step_plain(x, z0, z1, atb, gram, **kw), psf)
        bands = 2 * (len(gram.g_rows_acorr) + len(gram.g_cols_acorr))  # float32 ops per pixel
        key = "" if psf == "gauss" else "identity_"
        for k, (ms, pms) in times.items():
            res[k][key + "ms"], res[k][key + "plain_ms"] = ms, pms
        if psf != "gauss":
            res["K10"]["identity_bound"] = bound(7, 2 * (bands + STENCIL_FLOPS) * SHAPE[0] * SHAPE[1])
            res["K11"]["identity_bound"] = bound(7, (bands + STENCIL_FLOPS) * SHAPE[0] * SHAPE[1])
            continue
        res["K10"]["bound"] = bound(7, 2 * (bands + STENCIL_FLOPS) * SHAPE[0] * SHAPE[1])
        res["K11"]["bound"] = bound(7, (bands + STENCIL_FLOPS) * SHAPE[0] * SHAPE[1])
        cols = gram.band_plans()[1]
        w = gram_band_cols(x, cols).contiguous()
        res["K12"]["ms"], res["K12"]["plain_ms"] = note(
            "K12", "step", tv_pds_mega_step(x, zs, w, atb, gram, **kw),
            tv_pds_mega_step_plain(x, zs, w, atb, gram, **kw),
            lambda: tv_pds_mega_step(x, zs, w, atb, gram, **kw),
            lambda: tv_pds_mega_step_plain(x, zs, w, atb, gram, **kw), psf)
        res["K12"]["bound"] = bound(8, (2 * len(gram.g_rows_acorr) + STENCIL_FLOPS) * SHAPE[0] * SHAPE[1])
        res["K12"]["w_pass_ms"] = median_ms(lambda: gram_band_cols(x, cols).contiguous())
        log(f"  K12's w = ColGram(x) pass (PyTorch, outside the kernel): {res['K12']['w_pass_ms']:.4f} ms")
        g = sepgram2d_plain(x, gram.fwd, gram.adj2, atb)
        res["K13"]["ms"], res["K13"]["plain_ms"] = note(
            "K13", "step", tv_pds_stencil_step(x, zs, g, **kw), tv_pds_stencil_step_plain(x, zs, g, **kw),
            lambda: tv_pds_stencil_step(x, zs, g, **kw), lambda: tv_pds_stencil_step_plain(x, zs, g, **kw), psf)
        res["K13"]["bound"] = bound(7, STENCIL_FLOPS * SHAPE[0] * SHAPE[1])
    del zs, w, g

    # K8 at 4096^2: both PSFs, both prox modes, a momentum of 0.3 read from
    # the device; the times are those of the LASSO path's soft threshold
    mom = torch.tensor([0.3], device=dev)
    for psf, h in (("gauss", gaussian_kernel()), ("rank2", rank2_kernel())):
        us, vs = lowrank_factors(h)
        f = SepFactors(us, vs, h.shape[0] // 2, h.shape[1] // 2, dev)
        a2 = f.adjoint(2.0)
        for nonneg in (False, True):
            fk = dict(tau=0.5, lam=LAM_L1, nonneg=nonneg)
            ms = note("K8", f"nonneg={nonneg}", lasso_fista_step(x, z0, atb, mom, f, a2, **fk),
                      lasso_fista_step_plain(x, z0, atb, mom.reshape(()), f, a2, **fk),
                      lambda: lasso_fista_step(x, z0, atb, mom, f, a2, **fk),
                      lambda: lasso_fista_step_plain(x, z0, atb, mom.reshape(()), f, a2, **fk), psf)
            if not nonneg:
                key = "" if psf == "gauss" else "rank2_"
                res["K8"][key + "ms"], res["K8"][key + "plain_ms"] = ms
        key = "" if psf == "gauss" else "rank2_"
        res["K8"][key + "bound"] = bound(5, (4 * f.rank * (f.Ku + f.Kv) + 10) * SHAPE[0] * SHAPE[1])
    # K9 at 2048^2 with the Gaussian PSF: every prox mode, w 0 and 1, noise
    # streamed and drawn in the kernel; the times are those of the PMYULA
    # path (soft threshold, w = 1, prng)
    S2 = SHAPE_MCMC
    x2, atb2, m1, xi = (t(rng.standard_normal(S2)) for _ in range(4))
    m2 = t(np.abs(rng.standard_normal(S2)))
    h = gaussian_kernel()
    us, vs = lowrank_factors(h)
    f = SepFactors(us, vs, h.shape[0] // 2, h.shape[1] // 2, dev)
    a2 = f.adjoint(2.0)
    si = torch.tensor([3, 25], dtype=torch.int32, device=dev)
    for mode in ("stream", "prng"):
        for prox in ("none", "nonneg", "l1"):
            for w in (0.0, 1.0):
                wf = torch.tensor([w], device=dev)
                pk = dict(gamma=1 / 3, tau=1.0, lam=LAM_L1, prox_mode=prox, noise_mode=mode,
                          noise=xi if mode == "stream" else None)
                ms = note("K9", f"{mode} w={w:g}", pmyula_mega_step(x2, atb2, m1, m2, si, wf, f, a2, **pk),
                          pmyula_mega_step_plain(x2, atb2, m1, m2, si, wf, f, a2, **pk),
                          lambda: pmyula_mega_step(x2, atb2, m1, m2, si, wf, f, a2, **pk),
                          lambda: pmyula_mega_step_plain(x2, atb2, m1, m2, si, wf, f, a2, **pk), prox)
                if prox == "l1" and w == 1.0:
                    key = "" if mode == "prng" else "stream_"
                    res["K9"][key + "ms"], res["K9"][key + "plain_ms"] = ms
    # prng mode: x, atb, m1, m2 in, x, m1, m2 out; the Box-Muller and Philox
    # arithmetic is a few dozen operations a pixel, integer for the most part
    res["K9"]["bound"] = bound(7, (4 * f.rank * (f.Ku + f.Kv) + 30) * S2[0] * S2[1], shape=S2)
    noise_moments(dev)
    torch.cuda.synchronize()

    # the floors the stream-bound kernels are held to: a device-to-device
    # copy of their image streams' worth, n images, which itself moves 2 x n
    # images: 7 (K4, K11, K13, K10 for two iterations), 8 (K5, K6 for two
    # iterations, K7, K12) and 5 (K8) at 4096^2, 7 (K9) at 2048^2
    copy_ms = {}
    for streams, shape in ((7, SHAPE), (8, SHAPE), (5, SHAPE), (7, S2)):
        n = streams * shape[0] * shape[1]
        label = f"{streams}x{shape[0] * shape[1] * 4 >> 20}MiB"
        src = torch.empty(n, dtype=torch.float32, device=dev).uniform_()
        dst = torch.empty_like(src)
        copy_ms[label] = median_ms(lambda: dst.copy_(src), reps=10)
        log(f"device-to-device copy of {label}: {copy_ms[label]:.4f} ms "
            f"({2 * n * 4 / copy_ms[label] / 1e6:.1f} GB/s read+write)")
        del src, dst
    log(f"gauss: K4 {res['K4']['ms']:.4f} ms, K7 {res['K7']['ms']:.4f} ms; K5 {res['K5']['ms']:.4f} ms, "
        f"K6 {res['K6']['ms']:.4f} ms for two iterations; K8 {res['K8']['ms']:.4f} ms; "
        f"K9 at {S2[0]}^2 {res['K9']['ms']:.4f} ms (streamed noise {res['K9']['stream_ms']:.4f} ms); "
        f"K10 {res['K10']['ms']:.4f} ms for two iterations, K11 {res['K11']['ms']:.4f} ms, "
        f"K12 {res['K12']['ms']:.4f} ms (+ {res['K12']['w_pass_ms']:.4f} ms for w), K13 {res['K13']['ms']:.4f} ms")
    for k, r in res.items():
        if "bound" in r:  # K14-K16: phase_shard_kernels
            log(f"  {k} bound {r['bound'][0]:.4f} ms by {r['bound'][1]}")
    return res, copy_ms


def noise_moments(dev):
    """K9's in-kernel noise at 2048^2: with x = atb = 0, a 1x1 PSF, no prox
    and gamma = 1/2 (sqrt(2 gamma) = 1) a sample is the noise itself.  Its
    mean must lie within 5/sqrt(N) of 0, its variance within 5 sqrt(2/N) of
    1, with no NaN, and it must be normal_noise(seed, n) within TOL_REL."""
    from pycsou_tpu_torch.kernels.conv2d import SepFactors
    from pycsou_tpu_torch.kernels.langevin import normal_noise, pmyula_mega_step

    f = SepFactors(np.ones((1, 1)), np.ones((1, 1)), 0, 0, dev)
    z = torch.zeros(SHAPE_MCMC, device=dev)
    si = torch.tensor([3, 25], dtype=torch.int32, device=dev)
    xi, _, _ = pmyula_mega_step(z, z, z, z, si, torch.zeros(1, device=dev), f, f.adjoint(2.0), gamma=0.5, tau=1.0)
    n = xi.numel()
    mean, var = float(xi.double().mean()), float(xi.double().var())
    ab, rel = max_err(xi, normal_noise(3, 25, SHAPE_MCMC, dev))
    ok = bool(torch.isfinite(xi).all()) and abs(mean) < 5 / math.sqrt(n) and abs(var - 1) < 5 * math.sqrt(2 / n)
    log(f"K9 prng noise at {SHAPE_MCMC[0]}^2: mean {mean:.3e} (bound {5 / math.sqrt(n):.3e}), variance "
        f"{var:.6f} (bound 1 +- {5 * math.sqrt(2 / n):.3e}), finite {bool(torch.isfinite(xi).all())}; "
        f"against normal_noise max abs err {ab:.3e} (rel {rel:.3e}, tol {TOL_REL:g})")
    if not ok or rel > TOL_REL:
        raise AssertionError("K9's in-kernel noise fails the moment check or disagrees with normal_noise")


def count_launches(counters, fn):
    """``fn()`` with every launch counter set to 0 just before it; returns
    its result and the launches it made, per kernel."""
    for c in counters:
        c.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {k: c.launches for k, c in zip(KERNELS, counters)}


def expect_launches(name, counts, exact, at_most=None):
    """The kernels of ``exact`` launched exactly so often, those of
    ``at_most`` no more often, every other kernel never."""
    at_most = at_most or {}
    for k, v in counts.items():
        if k in exact:
            ok, want = v == exact[k], exact[k]
        elif k in at_most:
            ok, want = v <= at_most[k], f"<= {at_most[k]}"
        else:
            ok, want = v == 0, 0
        if not ok:
            raise AssertionError(f"{name}: {k} launched {v} times, expected {want}")


def built_and_run(build, n=ITERS):
    """A run that builds a solver through its entry point and runs it for
    ``n`` iterations: ``(solver, state)``."""
    def run():
        solver = build()
        return solver, solver.run_fixed(n)
    return run


def recovery(state, x_true, observed, key="x"):
    """(||x - x_true||, ||observed - x_true||) for x = ``state[key]``, which
    must be a finite image of the full shape."""
    x = state[key]
    if tuple(x.shape) != SHAPE or not bool(torch.isfinite(x).all()):
        raise AssertionError(f"{key} is not a finite 4096 x 4096 image")
    return float(torch.linalg.vector_norm(x - x_true)), float(torch.linalg.vector_norm(observed - x_true))


def _entry(state, key):
    """``state[key]``; a TV engine's split dual stacked as the generic z."""
    if key == "z" and "z" not in state:
        return torch.stack([state["z0"], state["z1"]])
    return state[key]


def cross_check(name, counters, fn, ref, exact, at_most=None, keys=("x", "z")):
    """``fn()`` counted on its own, its ``keys`` held to ``ref`` within
    TOL_PATH x max(1, max |x|)."""
    o, counts = count_launches(counters, fn)
    log(f"{name}: run for {o['it']} iterations; launches {counts}")
    expect_launches(name, counts, exact, at_most)
    errs = {k: max_err(_entry(o, k), _entry(ref, k))[0] for k in keys}
    scale = max(1.0, float(ref["x"].abs().max()))
    log(f"{name} after {o['it']} iterations: " + ", ".join(f"max |d{k}| {e:.3e}" for k, e in errs.items())
        + f" (tol {TOL_PATH:g} x {scale:.3f})")
    if any(e > TOL_PATH * scale for e in errs.values()):
        raise AssertionError(f"{name} disagrees with the fused engine")
    return counts


def phase_main_path(dev, rng, counters):
    """The README's PDS at 4096^2 on the benchmark's problem (the ladder's
    pick), its recovery of a piecewise-constant image, the same PDS with the
    rank-2 PSF (megar: its launches, recovery, and the generic chain after
    6 iterations), and every conv-mode engine asked for by name, each
    counted on its own run and held to megar after 6 iterations (even:
    mega3 steps two at a time); small denoising at 1024^2 and the rank-2
    PSF's refusal of mega3."""
    from pycsou_tpu_torch.func import L21Norm, NonNegativeOrthant, SquaredL2Loss
    from pycsou_tpu_torch.ops import Convolve2D, Gradient
    from pycsou_tpu_torch.opt import PDS, TVDeconvolution

    h, x_true, y = make_problem(rng)
    yt = torch.from_numpy(y).to(dev)

    def expression(data, shape=SHAPE, psf=h, **kw):
        return PDS(
            shape, F=SquaredL2Loss(shape, data=data) * Convolve2D(shape, psf, device=dev),
            G=NonNegativeOrthant(shape), H=LAM * L21Norm((2,) + shape, axis=0),
            K=Gradient(shape), **kw,
        )

    def errors(state, x_true, data):
        return recovery(state, torch.from_numpy(x_true).to(dev), data)

    # the main path: the README expression built and run, nothing else; K1
    # twice for A^H y (LeastSquaresLoss and TVDeconvolution each form it,
    # as in the reference), the ladder's engine once per step
    (pds, st), main = count_launches(counters, built_and_run(lambda: expression(yt, max_iter=3000)))
    fused = pds._fused
    engine = getattr(fused, "stencil_mode", None)
    if type(fused) is not TVDeconvolution or engine not in ("mega3", "megar"):
        raise AssertionError(f"PDS fused onto {type(fused).__name__}[{engine}]")
    kmain = ENGINE_KERNEL[engine]
    RUN_OF[kmain] = "main path"
    log(f"main path: PDS -> TVDeconvolution[{engine}] built and run for {st['it']} iterations; "
        f"launches {main}")
    expect_launches("main path", main, {"K1": 2, kmain: ITERS // fused.iters_per_step})
    err, obs = errors(st, x_true, yt)
    log(f"PDS -> {type(fused).__name__}[{engine}] tau=sigma={pds.tau:.6f} rho={pds.rho}; "
        f"benchmark problem after {st['it']} iterations: ||x - x_true|| / ||y - x_true|| = {err / obs:.6f}")

    xb_true, yb = blocks_problem(rng, h)
    ybt = torch.from_numpy(yb).to(dev)
    sb = expression(ybt, max_iter=3000).run_fixed(ITERS)
    err, obs = errors(sb, xb_true, ybt)
    log(f"piecewise-constant image after {sb['it']} iterations: ||x - x_true|| = {err:.4f} "
        f"< ||y - x_true|| = {obs:.4f}: {err < obs}")
    if not err < obs:
        raise AssertionError("the recovery is no better than the blurred observation")

    # the same expression with the rank-2 PSF: outside the rank-1 engines'
    # gate, "auto" fuses it onto megar; K1 twice for A^H y, K4 once a step
    h2 = rank2_kernel()
    x2_true, y2 = blocks_problem(rng, h2)
    y2t = torch.from_numpy(y2).to(dev)
    name2 = "main path (rank-2 PSF)"
    (pds2, st2), main2 = count_launches(counters, built_and_run(lambda: expression(y2t, psf=h2, max_iter=3000)))
    fused2 = pds2._fused
    if type(fused2) is not TVDeconvolution or fused2.stencil_mode != "megar":
        raise AssertionError(f"{name2}: PDS fused onto {type(fused2).__name__}[{getattr(fused2, 'stencil_mode', None)}]")
    log(f"{name2}: PDS -> TVDeconvolution[megar] built and run for {st2['it']} iterations; launches {main2}")
    expect_launches(name2, main2, {"K1": 2, "K4": ITERS})
    err, obs = errors(st2, x2_true, y2t)
    log(f"{name2}: ||x - x_true|| = {err:.4f} < ||y - x_true|| = {obs:.4f}: {err < obs} (ratio {err / obs:.6f})")
    if not err < obs:
        raise AssertionError(f"{name2}: the recovery is no better than the blurred observation")

    # every conv-mode engine on the card, each counted on its own against
    # megar after 6 iterations; the generic chain (fuse=False: the K2
    # gradient and plain operators) too; K1 forms A^H y
    n = 6
    runs = {"main path": main, name2: main2}
    solvers = {"main path": pds, name2: pds2}
    runs[f"{name2} PDS fuse=False"] = cross_check(
        f"{name2} PDS fuse=False", counters,
        lambda: expression(y2t, psf=h2, max_iter=3000, fuse=False).run_fixed(n), pds2.run_fixed(n), {"K2": n},
        {"K1": 2})

    def tv(stencil):
        return TVDeconvolution(SHAPE, yt, LAM, filt=h, stencil=stencil, max_iter=3000)

    name = "TVDeconvolution stencil='megar'"
    (solvers["megar"], ref), runs[name] = count_launches(counters, built_and_run(lambda: tv("megar"), n))
    expect_launches(name, runs[name], {"K4": n}, {"K1": 2})
    runs["PDS fuse=False"] = cross_check(
        "PDS fuse=False", counters, lambda: expression(yt, max_iter=3000, fuse=False).run_fixed(n),
        ref, {"K2": n}, {"K1": 2})
    solvers["fuse=False"] = expression(yt, max_iter=3000, fuse=False)  # timed in main
    for e in ("mega3", "mega2", "mega", "sweep", "element"):
        name = f"TVDeconvolution stencil='{e}'"
        k = ENGINE_KERNEL[e]
        exact = {k: n // 2 if e == "mega3" else n}
        if e in ("sweep", "element"):
            exact["K2"] = n
        solvers[e] = tv(e)
        runs[name] = cross_check(name, counters, lambda: solvers[e].run_fixed(n), ref, exact, {"K1": 2})

    # small denoising (filt None, < 2**21 pixels): the conv mode's identity
    # PSF and the ladder's pick, counted on its own run
    small = (1024, 1024)
    yd = torch.from_numpy(blocks_image(rng, small) + 0.1 * rng.standard_normal(small).astype(np.float32)).to(dev)

    def denoise():
        return PDS(small, F=SquaredL2Loss(small, data=yd), G=NonNegativeOrthant(small),
                   H=LAM * L21Norm((2,) + small, axis=0), K=Gradient(small), max_iter=3000)

    (dn, sd), counts = count_launches(counters, built_and_run(denoise))
    dfused = dn._fused
    log(f"small denoising at {small[0]}^2: PDS -> TVDeconvolution[{dfused.stencil_mode}] ({dfused.mode} mode, "
        f"{tuple(dfused.filt.shape)} PSF) run for {sd['it']} iterations; launches {counts}")
    if dfused.mode != "conv" or dfused.stencil_mode != engine:
        raise AssertionError(f"small denoising runs {dfused.mode}[{dfused.stencil_mode}], expected conv[{engine}]")
    expect_launches("small denoising", counts, {kmain: ITERS // dfused.iters_per_step}, {"K1": 2})
    if not bool(torch.isfinite(sd["x"]).all()) or tuple(sd["x"].shape) != small:
        raise AssertionError("small denoising: x is not a finite image")
    runs["small denoising"] = counts

    # a rank-2 PSF is outside the rank-1 engines' gate: mega3 refuses it
    try:
        TVDeconvolution(SHAPE, yt, LAM, filt=rank2_kernel(), stencil="mega3")
    except ValueError as exc:
        log(f"rank-2 PSF with stencil='mega3' raises ValueError: {exc}")
    else:
        raise AssertionError("stencil='mega3' accepted a rank-2 PSF")
    return pds, runs, solvers


def phase_masked_paths(dev, rng, counters):
    """The masked paths at full size, each built through its entry point
    and run with the launch counters zeroed just before and read just
    after, on the piecewise-constant image."""
    from pycsou_tpu_torch.func import L21Norm, NonNegativeOrthant, SquaredL2Loss
    from pycsou_tpu_torch.ops import Convolve2D, DownSampling, Gradient, Masking
    from pycsou_tpu_torch.opt import CPS, PDS, TVDeconvolution

    h = gaussian_kernel()
    xt = torch.from_numpy(blocks_image(rng)).to(dev)

    def noise(shape, scale):
        return torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32)).to(dev)

    def tv():
        return LAM * L21Norm((2,) + SHAPE, axis=0)

    def pds(op, y, **kw):
        return PDS(SHAPE, F=SquaredL2Loss(op.codim_shape, data=y) * op, G=NonNegativeOrthant(SHAPE),
                   H=tv(), K=Gradient(SHAPE), max_iter=3000, **kw)

    M = Masking(SHAPE, keep_mask(), device=dev)
    D = DownSampling(SHAPE, 2)
    MA = M * Convolve2D(SHAPE, h, device=dev)
    y_in = M(xt) + noise(M.codim_shape, 0.01)
    y_ds = D(xt) + noise(D.codim_shape, 0.01)
    y_bl = MA(xt) + noise(M.codim_shape, 0.01)
    y_dn = xt + noise(SHAPE, 0.1)
    # name -> (entry point, engine, exact launches, launch bounds, the
    # observation the recovery must beat: the zero-filled back-projection,
    # or the noisy image)
    paths = {
        "inpainting": (lambda: pds(M, y_in), "sweepm2", {"K6": ITERS // 2}, {}, M.adjoint(y_in)),
        "zero-fill super-resolution": (lambda: pds(D, y_ds), "sweepm2", {"K6": ITERS // 2}, {},
                                       D.adjoint(y_ds)),
        "blurred super-resolution": (lambda: pds(MA, y_bl), "megarm", {"K7": ITERS}, {"K1": 2},
                                     M.adjoint(y_bl)),
        "denoising": (lambda: PDS(SHAPE, F=SquaredL2Loss(SHAPE, data=y_dn), G=NonNegativeOrthant(SHAPE),
                                  H=tv(), K=Gradient(SHAPE), max_iter=3000),
                      "sweepm2", {"K6": ITERS // 2}, {}, y_dn),
        "CPS denoising": (lambda: CPS(SHAPE, G=SquaredL2Loss(SHAPE, data=y_dn), H=tv(), K=Gradient(SHAPE),
                                      max_iter=3000),
                          "sweepm2", {"K6": ITERS // 2}, {}, y_dn),
    }
    runs, solvers = {}, {}
    for name, (build, engine, exact, at_most, observed) in paths.items():
        (solver, st), counts = count_launches(counters, built_and_run(build))
        fused = solver._fused
        if type(fused) is not TVDeconvolution or fused.stencil_mode != engine:
            raise AssertionError(
                f"{name}: fused onto {type(fused).__name__}[{getattr(fused, 'stencil_mode', None)}], "
                f"expected TVDeconvolution[{engine}]")
        log(f"{name}: {type(solver).__name__} -> TVDeconvolution[{engine}] ({fused.mode} mode) built "
            f"and run for {st['it']} iterations; launches {counts}")
        if st["it"] != ITERS:
            raise AssertionError(f"{name}: ran {st['it']} iterations, expected {ITERS}")
        expect_launches(name, counts, exact, at_most)
        err, obs = recovery(st, xt, observed)
        log(f"{name}: ||x - x_true|| = {err:.4f} < ||observation - x_true|| = {obs:.4f}: {err < obs} "
            f"(ratio {err / obs:.6f})")
        if not err < obs:
            raise AssertionError(f"{name}: the recovery is no better than the observation")
        runs[name], solvers[name] = counts, solver

    # cross-checks after an even number of iterations, each counted on its
    # own: sweepm2 against sweepm (K5) and the generic chain, megarm against
    # the generic chain (K1 forms A^H and A on it)
    n = 6
    inp = solvers["inpainting"]
    ref = inp.run_fixed(n)
    name = "TVDeconvolution stencil='sweepm'"
    runs[name] = cross_check(
        name, counters,
        lambda: TVDeconvolution(SHAPE, inp._fused.y, LAM, mask=inp._fused.mask, tau=inp.tau,
                                sigma=inp.sigma, stencil="sweepm", max_iter=3000).run_fixed(n),
        ref, {"K5": n})
    cross_check("inpainting PDS fuse=False", counters, lambda: pds(M, y_in, fuse=False).run_fixed(n), ref, {})
    ref = solvers["blurred super-resolution"].run_fixed(n)
    cross_check("blurred super-resolution PDS fuse=False", counters,
                lambda: pds(MA, y_bl, fuse=False).run_fixed(n), ref, {}, {"K1": 2 * n + 2})
    return runs, solvers


def sparse_problem(rng, h, shape=SHAPE, density=0.002):
    """Sparse spikes (0.2% of the pixels, heights 1 + U(0, 1)) with the
    benchmark's blur and 0.01 noise: the kind of image a LASSO recovers."""
    from scipy.signal import fftconvolve

    x_true = np.zeros(shape, np.float32)
    on = rng.random(shape) < density
    x_true[on] = 1.0 + rng.random(int(on.sum()))
    y = fftconvolve(x_true, h, mode="same").astype(np.float32)
    y += 0.01 * rng.standard_normal(shape).astype(np.float32)
    return x_true, y


def phase_lasso_path(dev, rng, counters):
    """The LASSO through APGD at 4096^2 (bench.py sec_lasso's problem and
    lam), counted on its own run, with the generic chain and a sparse-spike
    recovery."""
    from pycsou_tpu_torch.func import L1Norm, SquaredL2Loss
    from pycsou_tpu_torch.ops import Convolve2D
    from pycsou_tpu_torch.opt import APGD, LassoDeconvolution

    h, _, y = make_problem(rng)
    yt = torch.from_numpy(y).to(dev)

    def expression(data, **kw):
        return APGD(SHAPE, F=SquaredL2Loss(SHAPE, data=data) * Convolve2D(SHAPE, h, device=dev),
                    G=LAM_L1 * L1Norm(SHAPE), max_iter=3000, **kw)

    # K1 twice for A^H y (LeastSquaresLoss and LassoDeconvolution each form
    # it, as in the reference), K8 once per iteration
    (apgd, st), counts = count_launches(counters, built_and_run(lambda: expression(yt)))
    fused = apgd._fused
    if type(fused) is not LassoDeconvolution or fused.engine != "megaf":
        raise AssertionError(f"APGD fused onto {type(fused).__name__}[{getattr(fused, 'engine', None)}]")
    log(f"LASSO: APGD -> LassoDeconvolution[megaf] tau={apgd.tau:.6f} lam={fused.lam} built and run for "
        f"{st['it']} iterations; launches {counts}")
    expect_launches("LASSO", counts, {"K1": 2, "K8": ITERS})
    n = 5
    ref = apgd.run_fixed(n)
    cross_check("APGD fuse=False", counters, lambda: expression(yt, fuse=False).run_fixed(n), ref,
                {"K2": n}, {"K1": 2}, keys=("x", "x_temp"))
    x_true, ys = sparse_problem(rng, h)
    yst = torch.from_numpy(ys).to(dev)
    ss = expression(yst).run_fixed(ITERS)
    err, obs = recovery(ss, torch.from_numpy(x_true).to(dev), yst, key="x_temp")
    log(f"LASSO on sparse spikes after {ss['it']} iterations: ||x - x_true|| = {err:.4f} < ||y - x_true|| = "
        f"{obs:.4f}: {err < obs} (ratio {err / obs:.6f})")
    if not err < obs:
        raise AssertionError("the LASSO recovery is no better than the blurred observation")
    return apgd, counts


def rank6_kernel(k=KSIZE):
    """bench.py sec_rank6's PSF: the sum of 6 random outer products (seed
    11), unit l1 norm."""
    r = np.random.default_rng(11)
    u6 = r.standard_normal((k, 6))
    v6 = r.standard_normal((k, 6))
    h6 = (u6 @ v6.T).astype(np.float32)
    return h6 / np.abs(h6).sum()


def fullrank_kernel(k=KSIZE):
    """bench.py sec_fullrank's PSF: |N(0, 1)| taps (seed 7), unit sum.  Its
    numerical rank is k: 15 at bench.py's 15 x 15, inside 'bandg''s 5-16,
    17 at FULLRANK_FFT_K."""
    r = np.random.default_rng(7)
    hf = np.abs(r.standard_normal((k, k))).astype(np.float32)
    return hf / hf.sum()


def phase_other_psfs(dev, rng, counters, res):
    """PSFs outside the band gate at 4096^2, each through PDS fusion and
    TVDeconvolution directly with the counters zeroed just before and read
    just after, recovering a piecewise-constant image, and held after 5
    iterations to the same solver on a second route to its Gram: the rank-6
    PSF ('bandg' + sweep: K1 4 and K3 once an iteration) against the FFT
    Gram, the 17 x 17 full-rank PSF (the FFT Gram's wrap path + sweep: K3
    once, no K1) against the padded FFT Gram, and bench.py's 15 x 15
    full-rank PSF (rank 15: 'bandg' in 4 groups, K1 8 and K3 once) against
    the FFT Gram; the full-rank LASSO on the "gram" engine (no kernel);
    K1 at rank 4 (a 'bandg' group); one Gram apply of each route."""
    from pycsou_tpu_torch.func import L1Norm, L21Norm, NonNegativeOrthant, SquaredL2Loss
    from pycsou_tpu_torch.kernels.conv2d import sepconv2d, sepconv2d_plain
    from pycsou_tpu_torch.ops import Convolve2D, ConvGram2D, Gradient
    from pycsou_tpu_torch.opt import APGD, LassoDeconvolution, PDS, TVDeconvolution

    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)  # noqa: E731
    # name -> (PSF, the Convolve2D method "auto" takes on the card, K1
    # launches an iteration, the second route to its Gram)
    psfs = {
        "rank 6": (rank6_kernel(), "bandg", 4, "fft"),
        f"full rank {FULLRANK_FFT_K}x{FULLRANK_FFT_K}": (fullrank_kernel(FULLRANK_FFT_K), "fft", 0, "padded"),
        f"full rank {KSIZE}x{KSIZE}": (fullrank_kernel(), "bandg", 8, "fft"),
    }
    runs, solvers = {}, {}
    for name, (h, method, k1, second) in psfs.items():
        A = Convolve2D(SHAPE, h, device=dev)
        groups = len(A.groups) if A.groups else 0
        if A.method != method or 2 * groups != k1:
            raise AssertionError(f"{name}: Convolve2D takes {A.method!r} with {groups} groups, expected {method!r}")
        x_true, y = blocks_problem(rng, h)
        xt, yt = t(x_true), t(y)

        def pds(h=h, yt=yt):
            return PDS(SHAPE, F=SquaredL2Loss(SHAPE, data=yt) * Convolve2D(SHAPE, h, device=dev),
                       G=NonNegativeOrthant(SHAPE), H=LAM * L21Norm((2,) + SHAPE, axis=0), K=Gradient(SHAPE),
                       max_iter=3000)

        def direct(h=h, yt=yt):
            return TVDeconvolution(SHAPE, yt, LAM, filt=h, max_iter=3000)

        # K1 forms A^H y once a group (twice through PDS: LeastSquaresLoss
        # and TVDeconvolution each form it, as in the reference)
        for route, build, ahy in ((f"{name} PDS", pds, 2 * groups), (f"{name} TVDeconvolution", direct, groups)):
            (solver, st), counts = count_launches(counters, built_and_run(build))
            tv = getattr(solver, "_fused", solver)
            gram = type(tv.gram).__name__ if tv is not None else None
            want = "SymmetricLinearOperator" if method == "bandg" else "ConvGram2D"
            if type(tv) is not TVDeconvolution or tv.stencil_mode != "sweep" or gram != want:
                raise AssertionError(f"{route}: runs {type(tv).__name__}[{getattr(tv, 'stencil_mode', None)}] "
                                     f"with a {gram} Gram, expected TVDeconvolution[sweep] with a {want}")
            if method == "fft" and not tv.gram.wrap:
                raise AssertionError(f"{route}: ConvGram2D took its padded path at {SHAPE}")
            log(f"{route}: -> TVDeconvolution[sweep] with a {gram} Gram ({A.method}"
                + (f", wrap={tv.gram.wrap}" if method == "fft" else f", {groups} groups") + ") built and run "
                f"for {st['it']} iterations; launches {counts}")
            expect_launches(route, counts, {"K3": ITERS, **({"K1": ahy + k1 * ITERS} if k1 else {})})
            err, obs = recovery(st, xt, yt)
            log(f"{route}: ||x - x_true|| = {err:.4f} < ||y - x_true|| = {obs:.4f}: {err < obs} "
                f"(ratio {err / obs:.6f})")
            if not err < obs:
                raise AssertionError(f"{route}: the recovery is no better than the blurred observation")
            runs[route], solvers[route] = counts, solver
        n = 5
        ref = solvers[f"{name} TVDeconvolution"].run_fixed(n)

        def on_second(h=h, yt=yt, second=second):
            s = TVDeconvolution(SHAPE, yt, LAM, filt=h, max_iter=3000)
            if second == "fft":
                s.gram = Convolve2D(SHAPE, h, method="fft", device=dev).gram
            else:
                s.gram = ConvGram2D(Convolve2D(SHAPE, h, device=dev), wrap=False)
            return s

        route = f"{name} on the {'FFT' if second == 'fft' else 'padded FFT'} Gram"
        solvers[route] = on_second()
        cross_check(route, counters, lambda: on_second().run_fixed(n), ref, {"K3": n}, {"K1": groups})

    # the full-rank LASSO: APGD fuses onto LassoDeconvolution["gram"] with
    # the FFT Gram; no kernel of the port runs (cuFFT and PyTorch only)
    hf = fullrank_kernel(FULLRANK_FFT_K)
    x_sp, ys = sparse_problem(rng, hf)
    yst = t(ys)

    def lasso(**kw):
        return APGD(SHAPE, F=SquaredL2Loss(SHAPE, data=yst) * Convolve2D(SHAPE, hf, device=dev),
                    G=LAM_L1 * L1Norm(SHAPE), max_iter=3000, **kw)

    name = f"full-rank LASSO ({FULLRANK_FFT_K}x{FULLRANK_FFT_K})"
    (apgd, st), counts = count_launches(counters, built_and_run(lasso))
    fused = apgd._fused
    if type(fused) is not LassoDeconvolution or fused.engine != "gram" or type(fused.gram) is not ConvGram2D:
        raise AssertionError(f"{name}: APGD fused onto {type(fused).__name__}[{getattr(fused, 'engine', None)}]")
    log(f"{name}: APGD -> LassoDeconvolution[gram] with a ConvGram2D (wrap={fused.gram.wrap}) built and run "
        f"for {st['it']} iterations; launches {counts}")
    expect_launches(name, counts, {})
    err, obs = recovery(st, t(x_sp), yst, key="x_temp")
    log(f"{name} on sparse spikes: ||x - x_true|| = {err:.4f} < ||y - x_true|| = {obs:.4f}: {err < obs} "
        f"(ratio {err / obs:.6f})")
    if not err < obs:
        raise AssertionError(f"{name}: the recovery is no better than the blurred observation")
    runs[name], solvers[name] = counts, apgd
    cross_check(f"{name} APGD fuse=False", counters, lambda: lasso(fuse=False).run_fixed(5), apgd.run_fixed(5),
                {}, keys=("x", "x_temp"))

    # K1 at rank 4, the size of a 'bandg' group: the rank-6 PSF's first group
    x = t(np.abs(rng.standard_normal(SHAPE)))
    f4 = Convolve2D(SHAPE, rank6_kernel(), device=dev).groups[0][0]
    ab, rel = max_err(sepconv2d(x, f4), sepconv2d_plain(x, f4))
    if rel > TOL_REL:
        raise AssertionError(f"K1 rank 4: err {ab:.3e} (rel {rel:.3e}) > {TOL_REL}")
    r1 = res["K1"]
    r1["max_abs_err"], r1["max_rel_err"] = max(r1["max_abs_err"], ab), max(r1["max_rel_err"], rel)
    r1["rank4_ms"], r1["rank4_plain_ms"] = median_ms(lambda: sepconv2d(x, f4)), median_ms(lambda: sepconv2d_plain(x, f4))
    r1["rank4_bound"] = bound(2, 2 * f4.rank * (f4.Ku + f4.Kv) * SHAPE[0] * SHAPE[1])
    log(f"  K1 rank 4 ({f4.Ku}x{f4.Kv} taps) max abs err {ab:.3e} (rel {rel:.3e}, tol {TOL_REL:g}); kernel "
        f"{r1['rank4_ms']:.4f} ms, plain {r1['rank4_plain_ms']:.4f} ms, bound {r1['rank4_bound'][0]:.4f} ms "
        f"by {r1['rank4_bound'][1]}")

    # one Gram apply of each route on the card, each held to the first of
    # its PSF's (the same operator)
    h15, h6 = fullrank_kernel(), rank6_kernel()
    C15 = Convolve2D(SHAPE, h15, method="fft", device=dev)
    C6 = Convolve2D(SHAPE, h6, method="fft", device=dev)
    full = f"{KSIZE}x{KSIZE} full rank"
    routes = {  # key -> (PSF, apply)
        f"ConvGram2D wrap ({full})": (full, ConvGram2D(C15).apply),
        f"ConvGram2D padded ({full})": (full, ConvGram2D(C15, wrap=False).apply),
        f"A^H(A x) over torch.fft ({full})": (full, lambda v: C15.adjoint(C15.apply(v))),
        f"bandg composition ({full}, 4 groups)": (full, Convolve2D(SHAPE, h15, device=dev).gram.apply),
        "ConvGram2D wrap (rank 6)": ("rank 6", ConvGram2D(C6).apply),
        "bandg composition (rank 6, 2 groups)": ("rank 6", Convolve2D(SHAPE, h6, device=dev).gram.apply),
    }
    gram_ms, gram_host_ms, first = {}, {}, {}
    for key, (psf, fn) in routes.items():
        got = fn(x)
        if psf in first:
            ab, rel = max_err(got, first[psf])
            if rel > TOL_REL:
                raise AssertionError(f"{key}: err {ab:.3e} (rel {rel:.3e}) against the first route > {TOL_REL}")
        else:
            first[psf], ab = got, 0.0
        gram_ms[key] = median_ms(lambda: fn(x), reps=10)
        gram_host_ms[key] = host_ms(lambda: fn(x), n=20)
        log(f"  Gram apply {key}: {gram_ms[key]:.4f} ms on the device, {gram_host_ms[key]:.4f} ms host a call "
            f"(max abs diff {ab:.3e} to the first route)")
    del first, x
    return runs, solvers, {"device_ms": gram_ms, "host_ms": gram_host_ms}


def phase_pmyula_path(dev, counters):
    """bench.py sec_mcmc's sampler at 2048^2, counted on its own run, with
    the generic chain on the same noise."""
    from scipy.signal import fftconvolve

    from pycsou_tpu_torch.func import L1Norm, SquaredL2Loss
    from pycsou_tpu_torch.ops import Convolve2D
    from pycsou_tpu_torch.opt import PMYULA

    rng = np.random.default_rng(6)
    h = gaussian_kernel()
    x_true = np.abs(rng.standard_normal(SHAPE_MCMC)).astype(np.float32)
    ym = torch.from_numpy(fftconvolve(x_true, h, mode="same").astype(np.float32)).to(dev)

    def sampler(**kw):
        return PMYULA(SHAPE_MCMC, F=SquaredL2Loss(SHAPE_MCMC, data=ym) * Convolve2D(SHAPE_MCMC, h, device=dev),
                      G=LAM_L1 * L1Norm(SHAPE_MCMC), seed=3, nb_burnin_iterations=20, max_iter=2000, **kw)

    (s, st), counts = count_launches(counters, built_and_run(sampler))
    if s.engine != "megal" or s._prox_mode != "l1":
        raise AssertionError(f"PMYULA runs engine {s.engine!r} (prox {s._prox_mode!r}), expected 'megal' (l1)")
    log(f"PMYULA[megal] tau={s.tau:.6f} gamma={s.gamma:.6f} built and run for {st['it']} samples; "
        f"launches {counts}")
    expect_launches("PMYULA", counts, {"K1": 2, "K9": ITERS})
    n = int(st["count"])
    mmse = st["mmse_raw"] / max(n, 1)
    if tuple(mmse.shape) != SHAPE_MCMC or not bool(torch.isfinite(mmse).all()) or n != ITERS - 21:
        raise AssertionError(f"PMYULA: {n} samples collected, or the MMSE is not a finite image")
    gap = abs(float(mmse.mean()) - float(x_true.mean()))
    log(f"PMYULA: {n} samples collected, mmse mean {float(mmse.mean()):.4f} (truth mean {x_true.mean():.4f}, "
        f"gap {gap:.4f} < 0.02: {gap < 0.02})")
    if not gap < 0.02:
        raise AssertionError("the MMSE's mean is not within 0.02 of the truth's")
    k = 6
    ref = s.run_fixed(k)
    cross_check("PMYULA use_pallas=False", counters, lambda: sampler(use_pallas=False).run_fixed(k), ref,
                {"K2": k}, {"K1": 2}, keys=("x", "mmse_raw", "m2_raw"))
    return s, counts


def phase_shard_kernels(dev, rng, res):
    """K14-K16 on the first, a middle and the last of SHARDS row shards of a
    4096^2 state, halos cut from it, against their plain versions; K14 and
    K16 across their tiles' edges on shards of 1 (K16), 16, 31, 33 and 920
    rows of a 1000 x 4095 state; and on a one-shard mesh (the whole image,
    zero halos) against K11 (bit for bit), K4 and K3."""
    from pycsou_tpu_torch.kernels.tv import (
        tv_pds_mega2_shard_step, tv_pds_mega2_shard_step_plain, tv_pds_mega2_step, tv_pds_sweep_shard_step,
        tv_pds_sweep_shard_step_plain, tv_pds_sweep_step_stats,
    )
    from pycsou_tpu_torch.kernels.tvr import tv_pds_megar_shard_step, tv_pds_megar_shard_step_plain, tv_pds_megar_step
    from pycsou_tpu_torch.ops import Convolve2D
    from pycsou_tpu_torch.parallel import halo_extend, halos

    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)  # noqa: E731
    x = t(np.abs(rng.standard_normal(SHAPE)))
    atb, g = t(rng.standard_normal(SHAPE)), t(rng.standard_normal(SHAPE))
    z0, z1 = t(0.01 * rng.standard_normal(SHAPE)), t(0.01 * rng.standard_normal(SHAPE))
    kw = dict(tau=0.3, sigma=0.3, rho=0.9, lam=LAM, nonneg=True, iso=True, H_global=SHAPE[0])
    gauss = Convolve2D(SHAPE, gaussian_kernel(), device=dev).gram
    rank2 = Convolve2D(SHAPE, rank2_kernel(), device=dev).gram
    H, W = SHAPE

    def check(k, label, got, want):
        for i, (a, b) in enumerate(zip(got, want)):
            if i == 3:
                rel = float(((a - b).abs() / b.abs().clamp(min=1e-30)).max())
                if rel > TOL_STATS:
                    raise AssertionError(f"{k} {label} stats rel err {rel:.3e} > {TOL_STATS}")
                continue
            ab, rel = max_err(a, b)
            res[k]["max_abs_err"] = max(res[k]["max_abs_err"], ab)
            res[k]["max_rel_err"] = max(res[k]["max_rel_err"], rel)
            if rel > TOL_REL:
                raise AssertionError(f"{k} {label} output {i}: err {ab:.3e} (rel {rel:.3e}) > {TOL_REL}")

    def run(k, R, arrays, call, plain):
        """``call``/``plain`` (shard index, core blocks, halos, off) on shards
        0, SHARDS // 2 and SHARDS - 1 of ``arrays`` split into SHARDS."""
        h = H // SHARDS
        cores = [[a[i * h : (i + 1) * h] for i in range(SHARDS)] for a in arrays]
        hls = halos(cores, R)
        res[k].update({"shard_ms": {}, "shard_plain_ms": {}})
        for i in (0, SHARDS // 2, SHARDS - 1):
            core = [c[i] for c in cores]
            args = (i, core, hls[i], i * h - R)
            check(k, f"shard {i}", call(*args), plain(*args))
            ms, pms = median_ms(lambda: call(*args)), median_ms(lambda: plain(*args))
            res[k]["shard_ms"][i], res[k]["shard_plain_ms"][i] = ms, pms
            log(f"  {k} shard {i} of {SHARDS} ({h} rows, {R} halo rows): max abs err "
                f"{res[k]['max_abs_err']:.3e} (rel {res[k]['max_rel_err']:.3e}, tol {TOL_REL:g}); "
                f"kernel {ms:.4f} ms, plain {pms:.4f} ms")
        # the times of a middle shard, which has both neighbours
        res[k]["ms"], res[k]["plain_ms"] = res[k]["shard_ms"][SHARDS // 2], res[k]["shard_plain_ms"][SHARDS // 2]

    h = H // SHARDS
    atbs = [atb[i * h : (i + 1) * h] for i in range(SHARDS)]
    R = 16
    exts = halo_extend(atbs, R)
    run("K14", R, (x, z0, z1),
        lambda i, c, hl, off: tv_pds_mega2_shard_step(*c, exts[i], hl, gauss, off, **kw),
        lambda i, c, hl, off: tv_pds_mega2_shard_step_plain(*c, exts[i], hl, gauss, off, **kw))
    bands = 2 * (len(gauss.g_rows_acorr) + len(gauss.g_cols_acorr))
    reach = (len(gauss.g_rows_acorr) - 1) // 2  # the Gram's rows each side
    res["K14"]["bound"] = bound(1, (bands + STENCIL_FLOPS) * h * W, shape=(shard_rows(h, reach), W))
    R = 32
    exts = halo_extend(atbs, R)
    f, a2 = rank2.fwd, rank2.adj2
    run("K15", R, (x, z0, z1),
        lambda i, c, hl, off: tv_pds_megar_shard_step(*c, exts[i], hl, f, a2, off, **kw),
        lambda i, c, hl, off: tv_pds_megar_shard_step_plain(*c, exts[i], hl, f, a2, off, **kw))
    res["K15"]["bound"] = bound(1, (4 * f.rank * (f.Ku + f.Kv) + STENCIL_FLOPS) * h * W,
                                shape=(shard_rows(h, f.Ku - 1), W))
    fg = gauss.fwd  # the Gaussian PSF's K15 (the A/B's control)
    res["K15"]["gauss_bound"] = bound(1, (4 * fg.rank * (fg.Ku + fg.Kv) + STENCIL_FLOPS) * h * W,
                                      shape=(shard_rows(h, fg.Ku - 1), W))
    run("K16", 1, (x, g, z0, z1),
        lambda i, c, hl, off: tv_pds_sweep_shard_step(c[0], c[1], c[2], c[3], hl, off, **kw),
        lambda i, c, hl, off: tv_pds_sweep_shard_step_plain(c[0], c[1], c[2], c[3], hl, off, **kw))
    res["K16"]["bound"] = bound(1, STENCIL_FLOPS * h * W, shape=(shard_rows(h, 0), W))

    # a one-shard mesh: the whole image with zero halos is the single-device kernel
    kw1 = {k: v for k, v in kw.items() if k != "H_global"}
    zeros = lambda R, n: tuple(torch.zeros((R, W), device=dev) for _ in range(n))  # noqa: E731
    pad = lambda a, R: torch.cat([a.new_zeros((R, W)), a, a.new_zeros((R, W))])  # noqa: E731
    one = {
        "K14": (tv_pds_mega2_shard_step(x, z0, z1, pad(atb, 16), zeros(16, 6), gauss, -16, **kw),
                tv_pds_mega2_step(x, z0, z1, atb, gauss, **kw1), "K11"),
        "K15": (tv_pds_megar_shard_step(x, z0, z1, pad(atb, 32), zeros(32, 6), f, a2, -32, **kw),
                tv_pds_megar_step(x, z0, z1, atb, f, a2, **kw1), "K4"),
        "K16": (tv_pds_sweep_shard_step(x, g, z0, z1, zeros(1, 8), -1, **kw),
                tv_pds_sweep_step_stats(x, z0, z1, g, **kw1), "K3"),
    }
    # the edges of K14's and K16's tiles (32 x 64): a 1000 x 4095 state (rows
    # of no multiple of 4 floats: 4-byte copies; a shifted last column tile)
    # cut into shards of 16, 31, 33 and 920 rows, and for K16 also 1 row
    He, We = 1000, 4095
    xe, ae, ge = t(np.abs(rng.standard_normal((He, We)))), t(rng.standard_normal((He, We))), \
        t(rng.standard_normal((He, We)))
    z0e, z1e = t(0.01 * rng.standard_normal((He, We))), t(0.01 * rng.standard_normal((He, We)))
    kwe = dict(kw, H_global=He)
    gauss_e = Convolve2D((He, We), gaussian_kernel(), device=dev).gram
    for k, cuts, R in (("K14", (0, 16, 47, 80, He), 16), ("K16", (0, 1, 17, 48, 81, He), 1)):
        cut = lambda a: [a[cuts[j]:cuts[j + 1]] for j in range(len(cuts) - 1)]  # noqa: E731
        if k == "K14":
            arrs, exts_e = (xe, z0e, z1e), halo_extend(cut(ae), R)
            step = lambda j, c, hl, off: tv_pds_mega2_shard_step(*c, exts_e[j], hl, gauss_e, off, **kwe)  # noqa: E731
            plain = lambda j, c, hl, off: tv_pds_mega2_shard_step_plain(*c, exts_e[j], hl, gauss_e, off, **kwe)  # noqa: E731
        else:
            arrs = (xe, ge, z0e, z1e)
            step = lambda j, c, hl, off: tv_pds_sweep_shard_step(*c, hl, off, **kwe)  # noqa: E731
            plain = lambda j, c, hl, off: tv_pds_sweep_shard_step_plain(*c, hl, off, **kwe)  # noqa: E731
        cores_e = [cut(a) for a in arrs]
        for j, hl in enumerate(halos(cores_e, R)):
            c = [a[j] for a in cores_e]
            check(k, f"{He} x {We}, rows [{cuts[j]}, {cuts[j + 1]})", step(j, c, hl, cuts[j] - R),
                  plain(j, c, hl, cuts[j] - R))
        log(f"  {k} on {len(cuts) - 1} shards of {He} x {We} ({[b - a for a, b in zip(cuts, cuts[1:])]} rows) against "
            f"its plain version: max abs err {res[k]['max_abs_err']:.3e} (rel {res[k]['max_rel_err']:.3e})")
    del xe, ae, ge, z0e, z1e, gauss_e

    for k, (got, want, single) in one.items():
        errs = [max_err(a, b) for a, b in zip(got[:3], want[:3])]
        res[k]["one_shard_max_abs_err"] = max(e[0] for e in errs)
        srel = float(((got[3] - want[3]).abs() / want[3].abs().clamp(min=1e-30)).max())
        log(f"  {k} on a one-shard mesh against {single}: max abs err {res[k]['one_shard_max_abs_err']:.3e}, "
            f"stats rel err {srel:.3e}")
        if max(e[1] for e in errs) > TOL_REL or srel > TOL_STATS:
            raise AssertionError(f"{k} on a one-shard mesh disagrees with {single}")
        if k == "K14" and not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError("K14 on a one-shard mesh is not bit for bit K11")
    torch.cuda.synchronize()
    for k in ("K14", "K15", "K16"):
        log(f"  {k} bound {res[k]['bound'][0]:.4f} ms by {res[k]['bound'][1]} (a shard)")


def phase_sharded_paths(dev, rng, counters):
    """DistributedTVDeconv2D's three engines on SHARDS row shards on one
    card, each built and run on its own with the counters zeroed, its
    recovery of a piecewise-constant image, and each against the
    single-device engine after 6 iterations."""
    from scipy.signal import fftconvolve

    from pycsou_tpu_torch.opt import TVDeconvolution
    from pycsou_tpu_torch.parallel import DistributedTVDeconv2D, make_mesh

    mesh = make_mesh((SHARDS,), devices=[dev] * SHARDS)
    xb = blocks_image(rng, SHAPE)
    noisy = lambda a: (a + 0.01 * rng.standard_normal(SHAPE)).astype(np.float32)  # noqa: E731
    m = keep_mask(SHAPE).astype(np.float32)
    psfs = {"megasp": gaussian_kernel(), "megarsp": rank2_kernel(), "sweepsp": None}
    ys = {e: noisy(fftconvolve(xb, h, mode="same")) for e, h in psfs.items() if h is not None}
    ys["sweepsp"] = m * noisy(xb)
    # engine -> (exact launches, the single-device engine it must agree with)
    plan = {"megasp": ({"K1": SHARDS, "K14": SHARDS * ITERS}, "mega2"),
            "megarsp": ({"K1": SHARDS, "K15": SHARDS * ITERS}, "megar"),
            "sweepsp": ({"K16": SHARDS * ITERS}, "sweepm")}
    runs, solvers = {}, {}
    x_true = torch.from_numpy(xb).to(dev)
    for engine, (exact, single) in plan.items():
        name = f"sharded {engine}"
        y = torch.from_numpy(ys[engine]).to(dev)
        mask = torch.from_numpy(m).to(dev) if engine == "sweepsp" else None

        def build():
            return DistributedTVDeconv2D(SHAPE, psfs[engine], y, LAM, mesh=mesh, mask=mask, max_iter=3000)

        (solver, st), counts = count_launches(counters, built_and_run(build))
        if solver._sp_engine != engine:
            raise AssertionError(f"{name}: DistributedTVDeconv2D picked {solver._sp_engine}")
        log(f"{name}: DistributedTVDeconv2D[{engine}] on {SHARDS} shards of {SHAPE[0] // SHARDS} rows on "
            f"{dev} built and run for {st['it']} iterations; launches {counts}")
        expect_launches(name, counts, exact)
        err, obs = recovery({"x": solver._gather(st["x"])}, x_true, y)
        log(f"{name}: ||x - x_true|| = {err:.4f} < ||observation - x_true|| = {obs:.4f}: {err < obs} "
            f"(ratio {err / obs:.6f})")
        if not err < obs:
            raise AssertionError(f"{name}: the recovery is no better than the observation")
        n = 6
        got = solver.postprocess(solver.run_fixed(n))
        ref = TVDeconvolution(SHAPE, y, LAM, filt=psfs[engine], mask=mask, stencil=single, tau=solver.tau,
                              sigma=solver.sigma, max_iter=3000).run_fixed(n)
        errs = {k: max_err(got[k], ref[k])[0] for k in ("x", "z0", "z1")}
        scale = max(1.0, float(ref["x"].abs().max()))
        log(f"{name} against TVDeconvolution[{single}] after {n} iterations: "
            + ", ".join(f"max |d{k}| {e:.3e}" for k, e in errs.items()) + f" (tol {TOL_PATH:g} x {scale:.3f})")
        if any(e > TOL_PATH * scale for e in errs.values()):
            raise AssertionError(f"{name} disagrees with TVDeconvolution[{single}]")
        runs[name], solvers[name] = counts, solver
    return runs, solvers


def phase_block_kernels(dev, rng, res):
    """K17 on four blocks of a (4, 4) mesh and on the four blocks of the
    path's (2, 2) mesh of a 4096^2 state, halos from the exchange, with
    both PSFs, against its plain version; on a one-block mesh (zero halos)
    against K4.  K18 at 4096^2 on both PSFs against its plain version and
    K2 without atb."""
    from pycsou_tpu_torch.kernels.conv2d import SepFactors, sepgram2d
    from pycsou_tpu_torch.kernels.sepgram import sepgram_apply, sepgram_apply_plain
    from pycsou_tpu_torch.kernels.tvr import (
        HALO_COLS, tv_pds_megar_shard2d_step, tv_pds_megar_shard2d_step_plain, tv_pds_megar_step,
    )
    from pycsou_tpu_torch.ops.conv import lowrank_factors
    from pycsou_tpu_torch.parallel import halo_extend_2d, halos_2d, lane_extend

    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)  # noqa: E731
    x = t(np.abs(rng.standard_normal(SHAPE)))
    atb = t(rng.standard_normal(SHAPE))
    z0, z1 = t(0.01 * rng.standard_normal(SHAPE)), t(0.01 * rng.standard_normal(SHAPE))
    H, W = SHAPE
    C, R = HALO_COLS, 32
    kw = dict(tau=0.3, sigma=0.3, rho=0.9, lam=LAM, nonneg=True, iso=True)
    kw2 = dict(kw, H_global=H, W_global=W)

    def grid(a, n0, n1):
        h, w = H // n0, W // n1
        return tuple(tuple(a[i * h : (i + 1) * h, j * w : (j + 1) * w].contiguous() for j in range(n1))
                     for i in range(n0))

    def check(label, got, want):
        for i, (a, b) in enumerate(zip(got, want)):
            if i == 3:
                rel = float(((a - b).abs() / b.abs().clamp(min=1e-30)).max())
                if rel > TOL_STATS:
                    raise AssertionError(f"K17 {label} stats rel err {rel:.3e} > {TOL_STATS}")
                continue
            ab, rel = max_err(a, b)
            res["K17"]["max_abs_err"] = max(res["K17"]["max_abs_err"], ab)
            res["K17"]["max_rel_err"] = max(res["K17"]["max_rel_err"], rel)
            if rel > TOL_REL:
                raise AssertionError(f"K17 {label} output {i}: err {ab:.3e} (rel {rel:.3e}) > {TOL_REL}")

    res["K17"].update({"block_ms": {}, "block_plain_ms": {}})
    k18_taps = []
    for psf, hk in (("gauss", gaussian_kernel()), ("rank2", rank2_kernel())):
        us, vs = lowrank_factors(hk)
        f = SepFactors(us, vs, hk.shape[0] // 2, hk.shape[1] // 2, dev)
        a2 = f.adjoint(2.0)
        for (n0, n1), blocks in (((4, 4), ((0, 0), (0, 2), (2, 2), (3, 3))),
                                 (MESH2D, tuple((i, j) for i in range(MESH2D[0]) for j in range(MESH2D[1])))):
            h, w = H // n0, W // n1
            ext = [lane_extend(grid(a, n0, n1), C) for a in (x, z0, z1)]
            hl, aext = halos_2d(ext, R), halo_extend_2d(grid(atb, n0, n1), R, C)
            times = []
            for i, j in blocks:
                args = (ext[0][i][j], ext[1][i][j], ext[2][i][j], aext[i][j], hl[i][j], f, a2, (i * h - R, j * w - C))
                label = f"{psf} ({n0}, {n1}) block ({i}, {j})"
                check(label, tv_pds_megar_shard2d_step(*args, **kw2), tv_pds_megar_shard2d_step_plain(*args, **kw2))
                ms = median_ms(lambda: tv_pds_megar_shard2d_step(*args, **kw2))
                pms = median_ms(lambda: tv_pds_megar_shard2d_step_plain(*args, **kw2))
                res["K17"]["block_ms"][label], res["K17"]["block_plain_ms"][label] = ms, pms
                times.append((ms, pms))
                log(f"  K17 {label} ({h} x {w}, {R} halo rows, {C} halo columns): max abs err "
                    f"{res['K17']['max_abs_err']:.3e} (rel {res['K17']['max_rel_err']:.3e}, tol {TOL_REL:g}); "
                    f"kernel {ms:.4f} ms, plain {pms:.4f} ms")
            del ext, hl, aext
        # the times on the path's blocks: the median of its four blocks
        key = "" if psf == "gauss" else "rank2_"
        res["K17"][key + "ms"] = statistics.median(m for m, _ in times)
        res["K17"][key + "plain_ms"] = statistics.median(p for _, p in times)
        taps = f.rank * (f.Ku + f.Kv)
        h, w = H // MESH2D[0], W // MESH2D[1]
        b = bound(1, (4 * taps + STENCIL_FLOPS) * h * w, shape=(block_elems(h, w, f.Ku - 1, f.Kv - 1), 1))
        res["K17"][key + "bound"] = b
        log(f"  K17 {psf} bound {b[0]:.4f} ms by {b[1]} (a {h} x {w} block)")

        # a one-block mesh: the whole image, zero halos, is K4
        if psf == "gauss":
            cpad = lambda a: torch.cat([a.new_zeros((a.shape[0], C)), a, a.new_zeros((a.shape[0], C))], 1)  # noqa: E731
            xe, z0e, z1e = cpad(x), cpad(z0), cpad(z1)
            ae = torch.cat([atb.new_zeros((R, W + 2 * C)), cpad(atb), atb.new_zeros((R, W + 2 * C))])
            zr = tuple(torch.zeros((R, W + 2 * C), device=dev) for _ in range(6))
            got = tv_pds_megar_shard2d_step(xe, z0e, z1e, ae, zr, f, a2, (-R, -C), **kw2)
            want = tv_pds_megar_step(x, z0, z1, atb, f, a2, **kw)
            errs = [max_err(a, b) for a, b in zip(got[:3], want[:3])]
            res["K17"]["one_block_max_abs_err"] = max(e[0] for e in errs)
            srel = float(((got[3] - want[3]).abs() / want[3].abs().clamp(min=1e-30)).max())
            log(f"  K17 on a one-block mesh against K4: max abs err {res['K17']['one_block_max_abs_err']:.3e}, "
                f"stats rel err {srel:.3e}")
            if max(e[1] for e in errs) > TOL_REL or srel > TOL_STATS:
                raise AssertionError("K17 on a one-block mesh disagrees with K4")
            del xe, z0e, z1e, ae, got, want

        # K18: A^H A x, against its plain version and K2 without atb
        ut, vt = tuple(map(tuple, us.T)), tuple(map(tuple, vs.T))
        k18_taps.append((ut, vt))
        g = sepgram_apply(x, ut, vt)
        ab, rel = max_err(g, sepgram_apply_plain(x, ut, vt))
        kab, krel = max_err(g, sepgram2d(x, f, f.adjoint()))
        res["K18"]["max_abs_err"] = max(res["K18"]["max_abs_err"], ab)
        res["K18"]["max_rel_err"] = max(res["K18"]["max_rel_err"], rel)
        res["K18"][key + "k2_max_abs_err"] = kab
        if rel > TOL_REL or krel > TOL_REL:
            raise AssertionError(f"K18 {psf}: rel err {rel:.3e} to its plain version, {krel:.3e} to K2")
        ms = median_ms(lambda: sepgram_apply(x, ut, vt))
        pms = median_ms(lambda: sepgram_apply_plain(x, ut, vt))
        res["K18"][key + "ms"], res["K18"][key + "plain_ms"] = ms, pms
        res["K18"][key + "bound"] = bound(2, 4 * taps * H * W)
        log(f"  K18 sepgram_apply {psf:<6} max abs err {ab:.3e} (rel {rel:.3e}, tol {TOL_REL:g}), to K2 {kab:.3e}; "
            f"kernel {ms:.4f} ms, plain {pms:.4f} ms")
    torch.cuda.synchronize()
    for k in ("K17", "K18"):
        log(f"  {k} bound {res[k]['bound'][0]:.4f} ms by {res[k]['bound'][1]}")
    # K18's run: no path of the package calls it, so its launches are
    # counted on direct calls, one per PSF
    return lambda: [sepgram_apply(x, ut, vt) for ut, vt in k18_taps]


def phase_spatial2d_paths(dev, rng, counters):
    """Spatial2DTVDeconv2D at 4096^2 on the (2, 2) mesh of one card, the
    Gaussian and the rank-2 PSF, each built and run on its own with the
    counters zeroed, its recovery of a piecewise-constant image, and each
    against TVDeconvolution[megar] after 6 iterations; then a (4, 1) mesh
    (the row-shard kernel K15) and a (1, 4) mesh (K17 with zero row halos),
    each built and run for 6 iterations with the counters zeroed and held
    to megar."""
    from scipy.signal import fftconvolve

    from pycsou_tpu_torch.opt import TVDeconvolution
    from pycsou_tpu_torch.parallel import Spatial2DTVDeconv2D, make_mesh

    def mesh(shape):
        return make_mesh(shape, ("sp0", "sp1"), devices=[dev] * (shape[0] * shape[1]))

    xb = blocks_image(rng, SHAPE)
    x_true = torch.from_numpy(xb).to(dev)
    n_blocks = MESH2D[0] * MESH2D[1]
    runs, solvers = {}, {}

    def agree(name, got, ref):
        errs = {k: max_err(got[k], ref[k])[0] for k in ("x", "z0", "z1")}
        scale = max(1.0, float(ref["x"].abs().max()))
        log(f"{name} against TVDeconvolution[megar] after {ref['it']} iterations: "
            + ", ".join(f"max |d{k}| {e:.3e}" for k, e in errs.items()) + f" (tol {TOL_PATH:g} x {scale:.3f})")
        if any(e > TOL_PATH * scale for e in errs.values()):
            raise AssertionError(f"{name} disagrees with TVDeconvolution[megar]")

    n = 6
    for psf, hk in (("gauss", gaussian_kernel()), ("rank2", rank2_kernel())):
        name = f"2-D mesh megar2d ({psf})"
        y = torch.from_numpy((fftconvolve(xb, hk, mode="same") + 0.01 * rng.standard_normal(SHAPE))
                             .astype(np.float32)).to(dev)

        def build(shape=MESH2D):
            return Spatial2DTVDeconv2D(SHAPE, hk, y, LAM, mesh=mesh(shape), max_iter=3000)

        (solver, st), counts = count_launches(counters, built_and_run(build))
        if solver._sp_engine != "megar2d":
            raise AssertionError(f"{name}: Spatial2DTVDeconv2D picked {solver._sp_engine!r}")
        log(f"{name}: Spatial2DTVDeconv2D[megar2d] on a {MESH2D} mesh of {SHAPE[0] // MESH2D[0]} x "
            f"{SHAPE[1] // MESH2D[1]} blocks on {dev} built and run for {st['it']} iterations; launches {counts}")
        expect_launches(name, counts, {"K1": n_blocks, "K17": n_blocks * ITERS})
        err, obs = recovery({"x": solver._gather(st["x"])}, x_true, y)
        log(f"{name}: ||x - x_true|| = {err:.4f} < ||observation - x_true|| = {obs:.4f}: {err < obs} "
            f"(ratio {err / obs:.6f})")
        if not err < obs:
            raise AssertionError(f"{name}: the recovery is no better than the observation")
        ref = TVDeconvolution(SHAPE, y, LAM, filt=hk, stencil="megar", tau=solver.tau, sigma=solver.sigma,
                              max_iter=3000).run_fixed(n)
        agree(name, solver.postprocess(solver.run_fixed(n)), ref)
        runs[name], solvers[name] = counts, solver
        if psf == "gauss":
            continue
        # the columns not cut (K15 on row blocks), the rows not cut (K17 with
        # zero row halos): 6 iterations each, counted on their own
        for shape, k in (((n_blocks, 1), "K15"), ((1, n_blocks), "K17")):
            sub = f"2-D mesh megar2d ({psf}) on a {shape} mesh"
            (other, st), counts = count_launches(counters, built_and_run(lambda: build(shape), n))
            log(f"{sub}: built and run for {st['it']} iterations; launches {counts}")
            expect_launches(sub, counts, {"K1": n_blocks, k: n_blocks * n})
            agree(sub, other.postprocess(st), ref)
            runs[sub] = counts
    return runs, solvers


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def cfg4_problem(m, device):
    """bench.py sec_cfg4_stacked at m x m: ``A = LinOpVStack([Masking,
    DCTOperator])`` with the keep mask ``default_rng(4).random < 0.3``,
    ``A.compute_lipschitz_cst(maxiter=30)``, ``APGD`` on ``SquaredL2Loss(y)
    * A`` with ``0.02 * L1Norm``, 40 spikes of 3.0.  Returns ``(A, solver,
    x_true, power-iteration record)``."""
    from pycsou_tpu_torch.func import L1Norm, SquaredL2Loss
    from pycsou_tpu_torch.ops import DCTOperator, LinOpVStack, Masking
    from pycsou_tpu_torch.opt import APGD
    from pycsou_tpu_torch.utils.opnorm import power_iteration

    rng = np.random.default_rng(4)
    mask = (rng.random((m, m)) < 0.3).astype(np.float32)
    A = LinOpVStack([Masking((m, m), mask, device=device), DCTOperator((m, m), device=device)])
    reads, applies = power_iteration.host_reads, power_iteration.applies
    _sync(device)
    t0 = time.perf_counter()
    A.compute_lipschitz_cst(maxiter=30)
    pi = {"wall_ms": 1e3 * (time.perf_counter() - t0), "host_reads": power_iteration.host_reads - reads,
          "gram_applies": power_iteration.applies - applies}
    x_true = np.zeros((m, m), np.float32)
    x_true[rng.choice(m, 40), rng.choice(m, 40)] = 3.0
    xt = torch.from_numpy(x_true).to(device)
    y = A(xt)
    solver = APGD((m, m), F=SquaredL2Loss(A.codim_shape, data=y) * A, G=0.02 * L1Norm((m, m)),
                  max_iter=2000, min_iter=10, accuracy_threshold=1e-6)
    return A, solver, xt, pi


def unknown_norm_pds(shape, h, y, device):
    """``PDS(F=SquaredL2Loss(y), H=L1Norm, K)`` with ``K`` the Convolve2D of
    ``h`` whose ``||K||`` is unknown (``_lipschitz=inf``): building it runs
    the power iteration on the card (tests/test_torch_slice.py builds the
    same)."""
    from pycsou_tpu_torch.func import L1Norm, SquaredL2Loss
    from pycsou_tpu_torch.ops import Convolve2D
    from pycsou_tpu_torch.opt import PDS

    K = Convolve2D(shape, h, device=device).replace(_lipschitz=float("inf"))
    return PDS(shape, F=SquaredL2Loss(shape, data=torch.as_tensor(y).to(device)), H=L1Norm(shape), K=K)


def spectral_operators(device):
    """The new operators at SHAPE_OPS (derivatives, stacks, Kronecker and
    transform operators, the structural ones), each built from the same
    numpy inputs on ``device``."""
    import scipy.sparse as sp

    from pycsou_tpu_torch import ops

    S = SHAPE_OPS
    n = S[0] * S[1]
    rng = np.random.default_rng(21)
    field = rng.standard_normal((2,) + S).astype(np.float32)
    d = rng.standard_normal(S).astype(np.float32)
    keep = rng.random(S) < 0.3
    fa = rng.standard_normal((S[0], S[0])).astype(np.float32) / np.sqrt(S[0])
    fb = rng.standard_normal((S[1], S[1])).astype(np.float32) / np.sqrt(S[1])
    ka = rng.standard_normal((S[0], 256)).astype(np.float32)
    kb = rng.standard_normal((S[1], 256)).astype(np.float32)
    band = sp.diags([rng.standard_normal(n - 1), rng.standard_normal(n), rng.standard_normal(n - S[1])],
                    [1, 0, -S[1]], shape=(n, n), format="csr", dtype=np.float32)
    dev = dict(device=device)
    D = ops.DiagonalOperator(d, **dev)
    dct, idct = ops.DCTOperator(S, **dev), ops.IDCTOperator(S, **dev)
    return {
        "FirstDerivative forward": ops.FirstDerivative(S, axis=0),
        "FirstDerivative backward": ops.FirstDerivative(S, axis=1, kind="backward"),
        "FirstDerivative centered": ops.FirstDerivative(S, axis=0, kind="centered", step=0.5),
        "SecondDerivative": ops.SecondDerivative(S, axis=1),
        "GeneralisedDerivative sobolev": ops.GeneralisedDerivative(S, axis=1, kind="sobolev", order=2,
                                                                   alpha=1.5, **dev),
        "GeneralisedDerivative polynomial": ops.GeneralisedDerivative(S, kind="polynomial",
                                                                      coeffs=[1.0, -0.5, 0.25], **dev),
        "Gradient backward": ops.Gradient(S, kind="backward"),
        "Gradient centered": ops.Gradient(S, kind="centered"),
        "Laplacian": ops.Laplacian(S),
        "GeneralisedLaplacian iterated": ops.GeneralisedLaplacian(S, order=2, **dev),
        "FirstDirectionalDerivative": ops.FirstDirectionalDerivative(S, field, **dev),
        "SecondDirectionalDerivative": ops.SecondDirectionalDerivative(S, field, **dev),
        "DirectionalGradient": ops.DirectionalGradient(S, [np.array([1.0, 0.0]), field], **dev),
        "DirectionalLaplacian": ops.DirectionalLaplacian(S, [np.array([0.6, 0.8]), field], weights=[0.5, 2.0],
                                                         **dev),
        "Integration1D": ops.Integration1D(S, axis=1, step=0.1),
        "LinOpVStack [Masking; DCT]": ops.LinOpVStack([ops.Masking(S, keep, **dev), dct]),
        "LinOpVStack [DCT; IDCT]": ops.LinOpVStack([dct, idct]),
        "LinOpHStack [DCT, Diagonal]": ops.LinOpHStack([dct, D]),
        "BlockDiagonalOperator": ops.BlockDiagonalOperator([dct, D]),
        "BlockOperator": ops.BlockOperator([[dct, D], [D, idct]]),
        "KroneckerProduct": ops.KroneckerProduct(ops.DenseOperator(fa, **dev), ops.DenseOperator(fb, **dev)),
        "KroneckerSum": ops.KroneckerSum(ops.DenseOperator(fa, **dev), ops.DiagonalOperator(fb[0], **dev)),
        "KhatriRaoProduct": ops.KhatriRaoProduct(ka, kb, **dev),
        "DCTOperator": dct,
        "IDCTOperator": idct,
        "FFTOperator": ops.FFTOperator(S),
        "DiagonalOperator": D,
        "PolynomialOperator": ops.PolynomialOperator(ops.Laplacian(S), [0.5, -1.0, 0.125]),
        "SparseOperator": ops.SparseOperator(band, dim_shape=S, codim_shape=S, **dev),
        "DenseOperator": ops.DenseOperator(fa, **dev),
    }


def phase_spectral(dev, counters):
    """The stacked operators and spectral estimates: cfg4 at 512^2 and
    4096^2 (its ||A|| against sqrt(2), the 512^2 run against the port's CPU
    run, recovery), the PDS with an unknown ||K|| (K1's launches from the
    power iteration), Lanczos and the smallest eigenvalue of a known
    spectrum, DenseOperator's spectrum against torch.linalg.svdvals, and
    every new operator on the card against its CPU run."""
    from pycsou_tpu_torch.ops import DenseOperator, DiagonalOperator
    from pycsou_tpu_torch.utils import opnorm
    from pycsou_tpu_torch.utils.device import full_f32

    t_phase = time.perf_counter()
    out = {"tolerances": {"sqrt2": TOL_SQRT2, "norm_card_cpu": TOL_NORM_CPU, "path": TOL_PATH,
                          "recovery": TOL_RECOVERY, "pi_card_cpu": TOL_PI_CPU, "ops": TOL_OPS,
                          "adjoint": TOL_ADJOINT, "spectrum": TOL_SPECTRUM}, "cfg4": {}}
    log(f"tolerances: {out['tolerances']}")
    solvers = {}
    sqrt2 = math.sqrt(2.0)
    for m in CFG4_SIZES:
        name = f"cfg4 {m}^2"
        (A, solver, xt, pi), counts = count_launches(counters, lambda: cfg4_problem(m, dev))
        expect_launches(f"{name} build", counts, {})
        log(f"{name}: ||A|| = {A.lipschitz!r} (sqrt(2) + {A.lipschitz - sqrt2:.3e}, tol {TOL_SQRT2:g}); power "
            f"iteration {pi['wall_ms']:.2f} ms wall, {pi['gram_applies']} Gram applies, {pi['host_reads']} host "
            f"reads; launches {counts}")
        if abs(A.lipschitz - sqrt2) > TOL_SQRT2:
            raise AssertionError(f"{name}: ||A|| is not sqrt(2)")
        st, counts = count_launches(counters, lambda: solver.run_fixed(20))
        expect_launches(f"{name} APGD", counts, {})
        rec = {"norm": A.lipschitz, "power_iteration": pi}
        if m == CFG4_SIZES[0]:
            A_c, solver_c, _, _ = cfg4_problem(m, "cpu")
            st_c = solver_c.run_fixed(20)
            rel = abs(A.lipschitz - A_c.lipschitz) / A_c.lipschitz
            scale = max(1.0, float(st_c["x"].abs().max()))
            errs = {k: float((st[k].cpu() - st_c[k]).abs().max()) for k in ("x", "x_temp")}
            log(f"{name} card against CPU: ||A|| rel {rel:.3e} (tol {TOL_NORM_CPU:g}); after 20 iterations "
                + ", ".join(f"max |d{k}| {e:.3e}" for k, e in errs.items()) + f" (tol {TOL_PATH:g} x {scale:.3f})")
            if rel > TOL_NORM_CPU or any(e > TOL_PATH * scale for e in errs.values()):
                raise AssertionError(f"{name}: the card disagrees with the CPU")
            rec.update(norm_rel_cpu=rel, path_err_cpu=errs)
        info = solver.solve()
        x = info["x_temp"]
        if tuple(x.shape) != (m, m) or not bool(torch.isfinite(x).all()):
            raise AssertionError(f"{name}: x is not a finite {m} x {m} image")
        err = float(torch.linalg.vector_norm(x - xt) / torch.linalg.vector_norm(xt))
        log(f"{name} solve(): {info.n_iter} iterations (converged {info.converged} at {info.converged_at}), "
            f"{info.elapsed:.3f} s; relative error {err:.4e} (tol {TOL_RECOVERY:g})")
        if err > TOL_RECOVERY:
            raise AssertionError(f"{name}: the recovered x is off")
        rec["ips"] = time_solver(solver)
        log(f"{name} APGD (generic) slope-timed: {rec['ips']:.1f} iters/s ({1e3 / rec['ips']:.4f} ms/iteration)")
        rec.update(recovery_rel_err=err, solve_s=info.elapsed, solve_iters=info.n_iter)
        out["cfg4"][m] = rec
        solvers[name] = solver

    # the PDS with an unknown ||K||: the main path's Gaussian PSF at 4096^2
    h = gaussian_kernel()
    y = np.random.default_rng(15).standard_normal(SHAPE).astype(np.float32)
    applies = opnorm.power_iteration.applies
    reads = opnorm.power_iteration.host_reads
    t0 = time.perf_counter()
    pds, counts = count_launches(counters, lambda: unknown_norm_pds(SHAPE, h, y, dev))
    build_ms = 1e3 * (time.perf_counter() - t0)
    n_gram = opnorm.power_iteration.applies - applies
    lip = pds.K.lipschitz
    log(f"unknown-||K|| PDS at {SHAPE[0]}^2: ||K|| = {lip!r} (bound 1 + 1e-5), {n_gram} Gram applies, "
        f"{opnorm.power_iteration.host_reads - reads} host reads, built in {build_ms:.1f} ms; launches {counts}")
    expect_launches("unknown-||K|| PDS build", counts, {"K1": 2 * n_gram})
    if not (0 < lip <= 1 + 1e-5):
        raise AssertionError("the power iteration's ||K|| is above 1 for a PSF summing to 1")
    st, counts20 = count_launches(counters, lambda: pds.run_fixed(20))
    log(f"unknown-||K|| PDS: 20 iterations; launches {counts20}")
    expect_launches("unknown-||K|| PDS run", counts20, {"K1": 40})
    if not all(bool(torch.isfinite(st[k]).all()) for k in ("x", "z")):
        raise AssertionError("unknown-||K|| PDS: non-finite iterates")
    y_small = y[: SHAPE_PI_CPU[0], : SHAPE_PI_CPU[1]]
    small = unknown_norm_pds(SHAPE_PI_CPU, h, y_small, dev).K.lipschitz
    small_cpu = unknown_norm_pds(SHAPE_PI_CPU, h, y_small, "cpu").K.lipschitz
    rel = abs(small - small_cpu) / small_cpu
    log(f"unknown-||K|| at {SHAPE_PI_CPU[0]}^2: card {small!r}, CPU {small_cpu!r}, rel {rel:.3e} "
        f"(tol {TOL_PI_CPU:g})")
    if rel > TOL_PI_CPU:
        raise AssertionError("the unknown-||K|| estimate differs between the card and the CPU")
    out["unknown_norm_pds"] = {"norm": lip, "gram_applies": n_gram, "k1_launches_build": counts["K1"],
                               "k1_launches_20_iterations": counts20["K1"], "build_ms": build_ms,
                               "norm_512": small, "norm_512_cpu": small_cpu}

    # Lanczos and the smallest eigenvalue of a known spectrum at 4096^2
    dg = np.random.default_rng(22).uniform(1.0, 2.0, SHAPE).astype(np.float32)
    dg[0, 0], dg[0, 1] = 5.0, 0.3
    Dg = DiagonalOperator(dg, device=dev)
    got = {"lanczos LA": float(opnorm.lanczos_eigs(Dg, k=1, which="LA", maxiter=32)[0]),
           "fold": opnorm.smallest_eig_psd(Dg, maxiter=32),
           "shift-invert": opnorm.smallest_eig_psd(Dg, maxiter=16, method="shift-invert", cg_tol=1e-5)}
    want = {"lanczos LA": 5.0, "fold": 0.3, "shift-invert": 0.3}
    spec = {}
    for k, v in got.items():
        spec[k] = e = abs(v - want[k]) / want[k]
        log(f"DiagonalOperator {SHAPE[0]}^2, {k}: {v!r} against {want[k]} (rel {e:.3e}, tol {TOL_SPECTRUM:g})")
    # DenseOperator N x N with singular values 6, 0.4 and the rest in [1, 3]
    g = torch.Generator(device=dev)
    g.manual_seed(7)
    U, _ = torch.linalg.qr(torch.randn(N_DENSE, N_DENSE, generator=g, device=dev))
    V, _ = torch.linalg.qr(torch.randn(N_DENSE, N_DENSE, generator=g, device=dev))
    sv_in = torch.cat([torch.tensor([6.0, 0.4], device=dev), 1.0 + 2.0 * torch.rand(N_DENSE - 2, generator=g, device=dev)])
    with full_f32():
        a = (U * sv_in) @ V.T
    # cuSOLVER's QR-based SVD (gesvd): on an H100 80GB HBM3 (700 W) PyTorch's
    # default method gave 6.0026 and 0.40013 for this matrix, built from 6.0
    # and 0.4, which the power iteration and Lanczos give
    sv = torch.linalg.svdvals(a, driver="gesvd" if a.is_cuda else None)
    smax, smin = float(sv[0]), float(sv[-1])
    log(f"DenseOperator {N_DENSE} x {N_DENSE}: svdvals {smax!r} ... {smin!r}; built from 6.0 ... 0.4")
    A = DenseOperator(a)
    got = {"opnorm": A.opnorm(), "singularvals LM": float(A.singularvals(k=1)[0]),
           "singularvals SM": float(A.singularvals(k=1, which="SM")[0]),
           "eigenvals of the Gram": float(A.gram.eigenvals(k=1)[0]), "cond": A.cond()}
    want = {"opnorm": smax, "singularvals LM": smax, "singularvals SM": smin, "eigenvals of the Gram": smax**2,
            "cond": smax / smin}
    for k, v in got.items():
        spec[f"dense {k}"] = e = abs(v - want[k]) / want[k]
        log(f"DenseOperator {N_DENSE} x {N_DENSE}, {k}: {v!r} against svdvals' {want[k]!r} (rel {e:.3e}, "
            f"tol {TOL_SPECTRUM:g})")
    del U, V, a, A
    if max(spec.values()) > TOL_SPECTRUM:
        raise AssertionError("a spectral estimate is off")
    out["spectrum_rel_err"] = spec

    # every new operator on the card against its CPU run, and its adjoint identity
    card, cpu = spectral_operators(dev), spectral_operators("cpu")
    rng = np.random.default_rng(23)
    worst = {}
    for name, op in card.items():
        op_c = cpu[name]

        def draw(shape):
            v = rng.standard_normal(shape).astype(np.float32)
            if op.dtype.is_complex:
                v = (v + 1j * rng.standard_normal(shape)).astype(np.complex64)
            return torch.from_numpy(v)

        x, yy = draw(op.dim_shape), draw(op.codim_shape)
        ax, ahy = op.apply(x.to(dev)), op.adjoint(yy.to(dev))
        ax_c, ahy_c = op_c.apply(x), op_c.adjoint(yy)
        e = max(float((ax.cpu() - ax_c).abs().max()) / max(1.0, float(ax_c.abs().max())),
                float((ahy.cpu() - ahy_c).abs().max()) / max(1.0, float(ahy_c.abs().max())))
        xd, yd = x.to(dev), yy.to(dev)
        lhs = torch.vdot(yd.reshape(-1), ax.reshape(-1))
        rhs = torch.vdot(ahy.reshape(-1), xd.reshape(-1))
        adj = float((lhs - rhs).abs() / (torch.linalg.vector_norm(ax) * torch.linalg.vector_norm(yd)))
        worst[name] = {"card_cpu": e, "adjoint": adj}
        if e > TOL_OPS or adj > TOL_ADJOINT:
            raise AssertionError(f"{name}: card against CPU {e:.3e} (tol {TOL_OPS:g}), adjoint {adj:.3e} "
                                 f"(tol {TOL_ADJOINT:g})")
    log(f"{len(card)} operators at {SHAPE_OPS[0]}^2, card against CPU (tol {TOL_OPS:g} x max(1, max |out|)) "
        f"and adjoint identity (tol {TOL_ADJOINT:g}): worst "
        f"{max(v['card_cpu'] for v in worst.values()):.3e}, {max(v['adjoint'] for v in worst.values()):.3e}")
    out["operators"] = worst
    out["materialise"] = materialise_and_pinv(dev)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"stacked operators and spectral estimates: {out['seconds']:.1f} s")
    return out, solvers


def wall_ms(fn, reps=5):
    """Median wall ms of a call of ``fn`` that reads the host itself,
    the device synchronised before and after each call."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def materialise_and_pinv(dev):
    """``todense`` of 1024 x 1024 matrices on the card: the DCT of 32 x 32
    images (8 vmapped batches of 128 columns; orthogonal, and the CPU's)
    and a band Convolve2D (K1 not batchable: a launch a column; the CPU's);
    and the pinv of a Kronecker product of two invertible N_KRON x N_KRON
    dense factors (one batched CG a factor): ``K pinv(y)`` against ``y``."""
    from pycsou_tpu_torch.ops import Convolve2D, DCTOperator, DenseOperator, KroneckerProduct
    from pycsou_tpu_torch.utils import opnorm
    from pycsou_tpu_torch.utils.device import full_f32

    out = {}
    h = gaussian_kernel()
    for name, build in (("DCTOperator", lambda d: DCTOperator(SHAPE_DENSE, device=d)),
                        ("Convolve2D band", lambda d: Convolve2D(SHAPE_DENSE, h, device=d))):
        op = build(dev)
        mat = op.todense().mat
        want = build("cpu").todense().mat
        e = float((mat.cpu() - want).abs().max()) / max(1.0, float(want.abs().max()))
        rec = {"batchable": op.batchable, "card_cpu": e, "ms": wall_ms(lambda: op.todense())}
        if name == "DCTOperator":
            with full_f32():
                rec["orthogonality"] = float((mat @ mat.T - torch.eye(op.dim, device=dev)).abs().max())
        log(f"todense {name} ({op.codim} x {op.dim}, batchable {op.batchable}): {rec['ms']:.3f} ms wall; card "
            f"against CPU {e:.3e} (tol {TOL_OPS:g})"
            + (f", |M M^T - I| {rec['orthogonality']:.3e} (tol {TOL_OPS:g})" if "orthogonality" in rec else ""))
        if e > TOL_OPS or rec.get("orthogonality", 0.0) > TOL_OPS:
            raise AssertionError(f"todense {name} is off")
        out[f"todense {name}"] = rec
    g = torch.Generator(device=dev)
    g.manual_seed(11)

    def factor():
        U, _ = torch.linalg.qr(torch.randn(N_KRON, N_KRON, generator=g, device=dev, dtype=torch.float64))
        V, _ = torch.linalg.qr(torch.randn(N_KRON, N_KRON, generator=g, device=dev, dtype=torch.float64))
        s = 1.0 + torch.rand(N_KRON, generator=g, device=dev, dtype=torch.float64)
        return DenseOperator(((U * s) @ V.T).to(torch.float32))

    K = KroneckerProduct(factor(), factor())
    y = torch.randn(N_KRON, N_KRON, generator=g, device=dev)
    reads, applies = opnorm.cg.host_reads, opnorm.cg.applies
    x = K.pinv(y, tol=1e-6)
    rec = {"host_reads": opnorm.cg.host_reads - reads, "batched_applies": opnorm.cg.applies - applies}
    rec["rel_residual"] = float(torch.linalg.vector_norm(K.apply(x) - y) / torch.linalg.vector_norm(y))
    rec["ms"] = wall_ms(lambda: K.pinv(y, tol=1e-6))
    log(f"KroneckerProduct pinv ({N_KRON} x {N_KRON} factors): {rec['ms']:.3f} ms wall, "
        f"{rec['batched_applies']} batched applies, {rec['host_reads']} host reads; ||K x - y|| / ||y|| "
        f"{rec['rel_residual']:.3e} (tol {TOL_PINV:g})")
    if not rec["rel_residual"] <= TOL_PINV:
        raise AssertionError("the Kronecker pinv is off")
    out["kron pinv"] = rec
    return out


def dispatch_floor_ms(dev, n=200):
    """The card's dispatch floor: median wall ms of one trivial launch and
    one host read (bench.py sec_dispatch's card twin)."""
    t = torch.zeros(1, device=dev)
    for _ in range(10):
        t.add_(1.0).item()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        t.add_(1.0).item()
        times.append(time.perf_counter() - t0)
    return 1e3 * statistics.median(times)


def cfg1_problem(y=None, device=None):
    """bench.py sec_cfg1_lasso1d: a 256-sample signal of 12 spikes
    (``default_rng(1)``), a 9-tap Gaussian (sigma 1.5) by ``Convolve1D``
    ('direct'), ``y = A x + 0.01`` noise (made on the CPU unless given),
    ``APGD`` with ``0.01 * L1Norm`` to 1e-6.  Returns ``(solver, y, g)``."""
    from pycsou_tpu_torch.func import L1Norm, SquaredL2Loss
    from pycsou_tpu_torch.ops import Convolve1D
    from pycsou_tpu_torch.opt import APGD

    n = 256
    rng = np.random.default_rng(1)
    x_true = np.zeros(n, np.float32)
    x_true[rng.choice(n, 12, replace=False)] = rng.standard_normal(12).astype(np.float32) + 2.0
    g = np.exp(-((np.arange(9) - 4) ** 2) / (2 * 1.5**2)).astype(np.float32)
    g /= g.sum()
    if y is None:
        y = Convolve1D((n,), g, device="cpu")(torch.from_numpy(x_true)).numpy()
        y = y + 0.01 * rng.standard_normal(n).astype(np.float32)
    A = Convolve1D((n,), g, device=device)
    solver = APGD((n,), F=SquaredL2Loss((n,), data=torch.from_numpy(y).to(device)) * A,
                  G=0.01 * L1Norm((n,)), max_iter=3000, min_iter=10, accuracy_threshold=1e-6)
    return solver, y, g


def cfg1_numpy_ms(y, g, tau, n_iter, lam=0.01):
    """bench.py's numpy FISTA twin of cfg1 (``np.convolve`` both ways),
    ``n_iter`` iterations: wall ms."""
    n = y.size
    gr = g[::-1]
    x = np.zeros(n, np.float32)
    xt_old = x.copy()
    t0 = time.perf_counter()
    for t_n in range(n_iter):
        grad = 2 * np.convolve(np.convolve(x, g, "same") - y, gr, "same")
        xt = np.sign(x - tau * grad) * np.maximum(np.abs(x - tau * grad) - tau * lam, 0)
        x = xt + t_n / (t_n + 75.0) * (xt - xt_old)
        xt_old = xt
    return 1e3 * (time.perf_counter() - t0)


def cfg5_problem(d, device, S=4):
    """bench.py sec_cfg5_admm3d at d^3: ``x = |N(0, 1)|`` and S scenarios of
    a random 3 x 3 x 3 PSF (normalised, in the corner: circular), their
    transfer functions, blurred data and 0.01 noise, all drawn from
    ``default_rng(5)`` in bench.py's order; the FFTs in float64 on
    ``device``.  Returns ``(h_hats complex64, data float32)`` there."""
    rng = np.random.default_rng(5)
    x_true = torch.from_numpy(np.abs(rng.standard_normal((d, d, d))).astype(np.float32)).to(device).double()
    X = torch.fft.rfftn(x_true)
    h_hats, data = [], []
    for _ in range(S):
        psf = torch.zeros((d, d, d), dtype=torch.float64, device=device)
        psf[:3, :3, :3] = torch.from_numpy(rng.random((3, 3, 3)).astype(np.float32).astype(np.float64))
        H = torch.fft.rfftn(psf / psf.sum())
        h_hats.append(H.to(torch.complex64))
        blur = torch.fft.irfftn(X * H, s=(d, d, d)).float()
        data.append(blur + 0.01 * torch.from_numpy(rng.standard_normal((d, d, d)).astype(np.float32)).to(device))
    return torch.stack(h_hats), torch.stack(data)


def cfg5_numpy_ms(h_hats, data, rho=1.0):
    """bench.py's numpy twin of cfg5: the same Fourier x-updates and
    averaging, best of 3 iterations, ms an iteration."""
    Hs, Ys = h_hats.cpu().numpy().astype(np.complex128), data.cpu().numpy()
    S, shape = Ys.shape[0], Ys.shape[1:]
    Yh = np.stack([np.fft.rfftn(Ys[s]) for s in range(S)])
    xs = np.zeros_like(Ys)
    u = np.zeros_like(Ys)
    z = np.zeros(shape, np.float32)
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for s in range(S):
            V = np.fft.rfftn(z - u[s])
            xs[s] = np.fft.irfftn((2 * np.conj(Hs[s]) * Yh[s] + rho * V) / (2 * np.abs(Hs[s]) ** 2 + rho), s=shape)
        z = (xs + u).mean(axis=0)
        u += xs - z
        best = min(best, time.perf_counter() - t0)
    return 1e3 * best


def _rel(got, want):
    """max |got - want| over max |want|."""
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)


def phase_conv_admm(dev, counters):
    """The 1-D, N-D and circular convolutions and consensus ADMM: cfg1 (time
    to 1e-6 beside its numpy twin and the dispatch floor, 20 iterations
    against the CPU), the 2^20-sample 1-D convolution on its two methods and
    its LASSO, ConvolveND at 256^3 on both Grams, MovingAverage2D's K1
    launches at 4096^2, CircularConvolve's pinv at 256^3, cfg5 at 64^3 and
    256^3 (64^3 against the CPU and bench.py's numpy twin), and the ADMM CG
    backend on band Convolve2Ds (K1 counted against the CG's applies)."""
    from pycsou_tpu_torch.func import L1Norm, NonNegativeOrthant, SquaredL2Loss
    from pycsou_tpu_torch.kernels.conv2d import sepconv2d_plain
    from pycsou_tpu_torch.ops import (CircularConvolve, Convolve1D, Convolve2D, ConvGramND, ConvolveND,
                                      MovingAverage2D)
    from pycsou_tpu_torch.opt import APGD, ConsensusADMM
    from pycsou_tpu_torch.opt.admm import stack_operators
    from pycsou_tpu_torch.parallel import make_mesh
    from pycsou_tpu_torch.utils.opnorm import cg

    t_phase = time.perf_counter()
    out = {"tolerances": {"cpu": TOL_CPU, "methods": TOL_REL, "adjoint": TOL_ADJOINT, "gram_nd": TOL_GRAM_ND,
                          "k1": TOL_REL, "pinv": TOL_PINV}}
    log(f"tolerances: {out['tolerances']}")
    cpu_mesh = make_mesh((1,), ("dp",), devices=["cpu"])

    def idle_share(solver, ips):
        busy = device_ms_per_iteration(solver)
        return None if busy is None else 1.0 - busy * ips / 1e3

    # cfg1: 256 samples, dispatch-bound
    solver, y1, g1 = cfg1_problem(device=dev)
    solver_c, _, _ = cfg1_problem(y=y1, device="cpu")
    st, counts = count_launches(counters, lambda: solver.run_fixed(20))
    expect_launches("cfg1 APGD", counts, {})
    st_c = solver_c.run_fixed(20)
    scale = float(st_c["x"].abs().max())
    err = max(float((st[k].cpu() - st_c[k]).abs().max()) for k in ("x", "x_temp"))
    log(f"cfg1 after 20 iterations: card against CPU max |dx| {err:.3e} (tol {TOL_CPU:g} x {scale:.3f}); "
        f"tau {solver.tau!r}, Gram {type(solver.F._gram).__name__}; launches {counts}")
    if err > TOL_CPU * scale:
        raise AssertionError("cfg1: the card disagrees with the CPU")
    solver.solve()  # warm
    _sync(dev)
    info = solver.solve()
    if not info.converged:
        raise AssertionError("cfg1 did not reach 1e-6")
    floor = dispatch_floor_ms(dev)
    np_ms = cfg1_numpy_ms(y1, g1, solver.tau, info.n_iter)
    ips = time_solver(solver)
    rec = {"time_to_1e6_ms": 1e3 * info.elapsed, "converged_at": info.converged_at, "n_iter": info.n_iter,
           "numpy_ms_same_iterations": np_ms, "dispatch_floor_ms": floor, "iters_per_s": ips,
           "device_idle_share": idle_share(solver, ips), "max_abs_err_cpu_20": err}
    log(f"cfg1 solve() to 1e-6 (warm): {rec['time_to_1e6_ms']:.2f} ms, converged at {info.converged_at} "
        f"({info.n_iter} run); numpy twin {np_ms:.2f} ms for {info.n_iter} iterations; dispatch floor "
        f"{floor:.4f} ms; {ips:.1f} iters/s, device idle share {rec['device_idle_share']}")
    out["cfg1"] = rec

    # the 1-D convolution at 2^20 samples, a 65-tap Gaussian, both methods
    h1 = np.exp(-((np.arange(TAPS_1D) - TAPS_1D // 2) ** 2) / (2 * 8.0**2)).astype(np.float32)
    h1 /= h1.sum()
    A_oa = Convolve1D((N_1D,), h1, device=dev)
    A_fft = Convolve1D((N_1D,), h1, method="fft", device=dev)
    if A_oa.method != "overlap-add":
        raise AssertionError(f"Convolve1D 'auto' took {A_oa.method!r} at {N_1D} samples, {TAPS_1D} taps")
    g = torch.Generator(device=dev)
    g.manual_seed(16)
    x = torch.randn(N_1D, generator=g, device=dev)
    yy = torch.randn(N_1D, generator=g, device=dev)
    rec = {"methods_rel_err": max(_rel(A_oa.apply(x), A_fft.apply(x)), _rel(A_oa.adjoint(yy), A_fft.adjoint(yy)))}
    G1 = A_oa.gram
    for name, A in (("overlap-add", A_oa), ("fft", A_fft)):
        ax, ahy = A.apply(x), A.adjoint(yy)
        rec[f"{name} adjoint_identity"] = float((torch.dot(yy, ax) - torch.dot(ahy, x)).abs()
                                                / (torch.linalg.vector_norm(ax) * torch.linalg.vector_norm(yy)))
        rec[f"{name} apply_ms"] = median_ms(lambda: A.apply(x))
        rec[f"{name} adjoint_ms"] = median_ms(lambda: A.adjoint(yy))
    rec["gram_ms"] = median_ms(lambda: G1.apply(x))
    rec["gram_rel_err"] = _rel(G1.apply(x), A_fft.adjoint(A_fft.apply(x)))
    log(f"Convolve1D at {N_1D}, {TAPS_1D} taps: 'overlap-add' against 'fft' {rec['methods_rel_err']:.3e} (tol "
        f"{TOL_REL:g}); adjoint identity {rec['overlap-add adjoint_identity']:.3e}, "
        f"{rec['fft adjoint_identity']:.3e} (tol {TOL_ADJOINT:g}); Gram against A^H A {rec['gram_rel_err']:.3e}; ms "
        + ", ".join(f"{k} {v:.4f}" for k, v in rec.items() if k.endswith("_ms")))
    if (rec["methods_rel_err"] > TOL_REL or rec["gram_rel_err"] > TOL_GRAM_ND
            or max(rec["overlap-add adjoint_identity"], rec["fft adjoint_identity"]) > TOL_ADJOINT):
        raise AssertionError("Convolve1D at 2^20: the methods, the adjoint or the Gram disagree")
    rng = np.random.default_rng(17)
    spikes = np.zeros(N_1D, np.float32)
    spikes[rng.choice(N_1D, N_1D // 500, replace=False)] = 3.0
    y_l = A_oa.apply(torch.from_numpy(spikes).to(dev)) + 0.01 * torch.randn(N_1D, generator=g, device=dev)
    lasso = APGD((N_1D,), F=SquaredL2Loss((N_1D,), data=y_l) * A_oa, G=0.01 * L1Norm((N_1D,)), max_iter=1000)
    _, counts = count_launches(counters, lambda: lasso.run_fixed(20))
    expect_launches("1-D LASSO", counts, {})
    rec["lasso_iters_per_s"] = time_solver(lasso)
    rec["lasso_device_idle_share"] = idle_share(lasso, rec["lasso_iters_per_s"])
    log(f"1-D LASSO at {N_1D} (APGD, ConvGram1D): {rec['lasso_iters_per_s']:.1f} iters/s, device idle share "
        f"{rec['lasso_device_idle_share']}")
    out["conv1d_2^20"] = rec
    del A_oa, A_fft, G1, lasso, x, yy, y_l

    # ConvolveND at 256^3: a 7^3 Gaussian (SeparableConvGramND) and a 5^3 draw (ConvGramND)
    u7 = np.exp(-((np.arange(7) - 3.0) ** 2) / (2 * 1.5**2))
    g7 = np.multiply.outer(np.multiply.outer(u7, u7), u7)
    r5 = np.random.default_rng(18).random((5, 5, 5))
    x3 = torch.randn(SHAPE_3D, generator=g, device=dev)
    for name, h, want in (("gauss7", g7 / g7.sum(), "SeparableConvGramND"), ("rand5", r5 / r5.sum(), "ConvGramND")):
        A = ConvolveND(SHAPE_3D, h.astype(np.float32), device=dev)
        G = A.gram
        if type(G).__name__ != want:
            raise AssertionError(f"ConvolveND {name}: Gram {type(G).__name__}, expected {want}")
        rec = {"gram": want, "apply_ms": median_ms(lambda: A.apply(x3)), "adjoint_ms": median_ms(lambda: A.adjoint(x3)),
               "gram_ms": median_ms(lambda: G.apply(x3))}
        ref = A.adjoint(A.apply(x3))
        rec["gram_rel_err"] = _rel(G.apply(x3), ref)
        if name == "gauss7":
            fftg = ConvGramND(A)
            rec["fft_gram_ms"] = median_ms(lambda: fftg.apply(x3))
            rec["sep_vs_fft_gram_rel_err"] = _rel(G.apply(x3), fftg.apply(x3))
            del fftg
        log(f"ConvolveND {SHAPE_3D[0]}^3 {name} ({want}): " + ", ".join(
            f"{k} {v:.4g}" if isinstance(v, float) else f"{k} {v}" for k, v in rec.items()) + f" (tol {TOL_GRAM_ND:g})")
        if rec["gram_rel_err"] > TOL_GRAM_ND or rec.get("sep_vs_fft_gram_rel_err", 0.0) > TOL_GRAM_ND:
            raise AssertionError(f"ConvolveND {name}: the Gram disagrees")
        out[f"convnd {name}"] = rec
        del A, G, ref

    # MovingAverage2D at 4096^2: a band Convolve2D, K1 once an apply and once an adjoint
    M = MovingAverage2D(SHAPE, (5, 5), device=dev)
    x2 = torch.randn(SHAPE, generator=g, device=dev)
    (ym, zm), counts = count_launches(counters, lambda: (M.apply(x2), M.adjoint(x2)))
    expect_launches("MovingAverage2D apply + adjoint", counts, {"K1": 2})
    e_apply, e_adj = max_err(ym, sepconv2d_plain(x2, M.fwd))[1], max_err(zm, sepconv2d_plain(x2, M.adj))[1]
    rec = {"method": M.method, "k1_launches": counts["K1"], "max_rel_err": max(e_apply, e_adj),
           "apply_ms": median_ms(lambda: M.apply(x2)), "plain_ms": median_ms(lambda: sepconv2d_plain(x2, M.fwd)),
           "bound": bound(2, 2 * M.fwd.rank * (M.fwd.Ku + M.fwd.Kv) * SHAPE[0] * SHAPE[1])}
    log(f"MovingAverage2D {SHAPE[0]}^2 (5, 5) ['{M.method}']: K1 {counts['K1']} for an apply and an adjoint; "
        f"against K1's plain version {e_apply:.3e}, {e_adj:.3e} (tol {TOL_REL:g} x max(1, max)); apply "
        f"{rec['apply_ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, bound {rec['bound'][0]:.4f} ms by "
        f"{rec['bound'][1]}")
    if rec["max_rel_err"] > TOL_REL:
        raise AssertionError("MovingAverage2D disagrees with K1's plain version")
    out["moving_average2d"] = rec
    del M, x2, ym, zm

    # CircularConvolve at 256^3: the exact Fourier pinv of an invertible filter (|H| >= 0.5)
    r = np.random.default_rng(19).standard_normal((5, 5, 5))
    hc = 0.5 * r / np.abs(r).sum()
    hc[2, 2, 2] += 1.0
    C = CircularConvolve(SHAPE_3D, hc.astype(np.float32), device=dev)
    yc = C.apply(x3)
    xr = C.pinv(yc)
    res = float(torch.linalg.vector_norm(C.apply(xr) - yc) / torch.linalg.vector_norm(yc))
    rec = {"pinv_residual": res, "x_rel_err": float(torch.linalg.vector_norm(xr - x3) / torch.linalg.vector_norm(x3)),
           "lipschitz": C.lipschitz, "apply_ms": median_ms(lambda: C.apply(x3)),
           "pinv_ms": median_ms(lambda: C.pinv(yc))}
    log(f"CircularConvolve {SHAPE_3D[0]}^3: pinv residual {res:.3e} (tol {TOL_PINV:g}), x recovered to "
        f"{rec['x_rel_err']:.3e}; apply {rec['apply_ms']:.4f} ms, pinv {rec['pinv_ms']:.4f} ms")
    if res > TOL_PINV:
        raise AssertionError("CircularConvolve's pinv misses")
    out["circular"] = rec
    del C, yc, xr, x3

    # cfg5: ConsensusADMM, Fourier backend, 4 scenarios, rho 1, on the default mesh (one card)
    for d in CFG5_SIZES:
        h_hats, data = cfg5_problem(d, dev)
        admm = ConsensusADMM((d, d, d), h_hats=h_hats, data=data, rho=1.0, max_iter=1000)
        z, counts = count_launches(counters, lambda: admm.run(20))
        expect_launches(f"cfg5 {d}^3", counts, {})
        rec = {"mesh": [str(v) for v in admm.mesh.devices]}
        if d == CFG5_SIZES[0]:
            h_c, data_c = h_hats.cpu(), data.cpu()
            z_c = ConsensusADMM((d, d, d), h_hats=h_c, data=data_c, rho=1.0, mesh=cpu_mesh).run(20)
            rec["max_abs_err_cpu_20"] = err = float((z.cpu() - z_c).abs().max())
            scale = float(z_c.abs().max())
            log(f"cfg5 {d}^3 after 20 iterations: card against CPU max |dz| {err:.3e} (tol {TOL_CPU:g} x {scale:.3f})")
            if err > TOL_CPU * scale:
                raise AssertionError("cfg5: the card disagrees with the CPU")
            rec["numpy_ms_per_iteration"] = cfg5_numpy_ms(h_c, data_c)
        rec["iters_per_s"] = time_solver(admm)
        rec["device_idle_share"] = idle_share(admm, rec["iters_per_s"])
        log(f"cfg5 {d}^3 x 4 ConsensusADMM[Fourier] on {rec['mesh']}: {rec['iters_per_s']:.1f} iters/s "
            f"({1e3 / rec['iters_per_s']:.4f} ms/iteration), device idle share {rec['device_idle_share']}"
            + (f"; numpy twin {rec['numpy_ms_per_iteration']:.2f} ms/iteration" if "numpy_ms_per_iteration" in rec
               else ""))
        out[f"cfg5 {d}^3"] = rec
        del admm, h_hats, data, z

    # the CG backend: band Convolve2Ds of four Gaussians at 1024^2, NonNegativeOrthant, 10 iterations
    ops = [Convolve2D(SHAPE_CG, gaussian_kernel(KSIZE, s), device=dev) for s in CG_SIGMAS]
    xt = torch.from_numpy(blocks_image(np.random.default_rng(20), SHAPE_CG)).to(dev)
    ys = torch.stack([op.apply(xt) + 0.01 * torch.randn(SHAPE_CG, generator=g, device=dev) for op in ops])
    admm = ConsensusADMM(SHAPE_CG, ops=stack_operators(ops), data=ys, g=NonNegativeOrthant(SHAPE_CG), rho=1.0)
    applies = cg.applies
    _sync(dev)
    t0 = time.perf_counter()
    z, counts = count_launches(counters, lambda: admm.run(10))
    wall = time.perf_counter() - t0
    n_app = cg.applies - applies
    S = len(ops)
    expect_launches("ADMM CG backend", counts, {"K1": S * 10 + 2 * S * n_app})
    err, obs = (float(torch.linalg.vector_norm(v - xt)) for v in (z, ys[0]))
    rec = {"k1_launches": counts["K1"], "cg_applies": n_app, "wall_ms_10_iterations": 1e3 * wall,
           "recovery_err": err, "observation_err": obs}
    log(f"ADMM CG backend, {S} band Convolve2Ds at {SHAPE_CG[0]}^2: K1 {counts['K1']} = {S} x 10 + 2 x {S} x "
        f"{n_app} CG applies; 10 iterations {1e3 * wall:.1f} ms; ||z - x|| {err:.2f} against the first "
        f"observation's {obs:.2f}")
    if not err < obs:
        raise AssertionError("ADMM CG backend: the recovery is no better than the observation")
    out["admm_cg"] = rec
    out["seconds"] = time.perf_counter() - t_phase
    log(f"convolutions and consensus ADMM: {out['seconds']:.1f} s")
    return out


# -- phase 13: the proximal calculus, the sampling operators, RBF fitting

SHAPE_P13_CPU = (1024, 1024)  # the stacked-K PDS and the group LASSO against the CPU after 20 iterations
LAM_POISSON = 0.5  # the TV weight of Poisson-TV deblurring, whose PDS starts at the observation
TILE = 8  # the group LASSO's groups: 8 x 8 tiles
NN_GRID = (512, 512)  # NNSampling's grid nodes (cut from 1024^2 with its samples: host KD-tree time)
NN_SAMPLES = 2**18  # NNSampling's samples (cut from 2^20)
N_SAMPLES = 2**20  # the Vandermonde matrix's samples
VDM_DEGREE = 15  # the Vandermonde matrix's monomials: degree 0..15
RBF_N = 50_000  # examples/rbf_interpolation.py main_large's points
TOL_PROX = 1e-5  # a prox, projection or apply on the card against the CPU, x max(1, max |CPU|)
# the sort-based thresholds (an ulp in a cumulative sum of 16.7 M terms moves the
# threshold), the fixed loops (24-60 steps compound a rounding) and index_add's
# segment sums (atomics in no fixed order) against the CPU
TOL_PROX_ITER = 1e-4
TOL_RBF_FIT = 1e-3  # main()'s fit error, card against CPU, absolute
PROX_BAND = 8  # an elementwise map is held to the CPU on the first 1/PROX_BAND of the rows


def no_sync(fn):
    """``fn()`` under ``torch.cuda.set_sync_debug_mode("error")``: a call
    that reads the host (a sync) raises."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return out


def peaks_image(shape, device):
    """``100 max(peaks, 0) / max`` on the [-3, 3]^2 grid of
    examples/deconv_tv_2048.py, through the port's ``peaks``."""
    from pycsou_tpu_torch.utils.misc import peaks

    g = torch.linspace(-3, 3, shape[0], device=device)
    xx, yy = torch.meshgrid(g, g, indexing="xy")
    p = torch.clamp(peaks(xx, yy), min=0.0)
    return 100.0 * p / p.max()


def poisson_tv_problem(shape, device):
    """Poisson-TV deblurring: the main path's band Convolve2D (15 x 15
    Gaussian, sigma 2) on the peaks image, ``y = Poisson(A x_true)`` from
    ``default_rng(17)``, made on ``device``.  Returns ``(build, x_true,
    y)``: ``build(on=device)`` makes ``PDS(G=NonNegativeOrthant,
    H=ProxFuncHStack([KLDivergence(y), lam * L21Norm]), K=LinOpVStack([A,
    Gradient]))`` on ``on``, started at the observation."""
    from pycsou_tpu_torch.func import KLDivergence, L21Norm, NonNegativeOrthant, ProxFuncHStack
    from pycsou_tpu_torch.ops import Convolve2D, Gradient, LinOpVStack
    from pycsou_tpu_torch.opt import PDS

    x_true = peaks_image(shape, device)
    ax = Convolve2D(shape, gaussian_kernel(), device=device).apply(x_true).cpu().numpy()
    y = torch.from_numpy(np.random.default_rng(17).poisson(np.maximum(ax, 0)).astype(np.float32)).to(device)

    def build(on=device):
        yy = y.to(on)
        H = ProxFuncHStack([KLDivergence(shape, yy), LAM_POISSON * L21Norm((2,) + shape, axis=0)])
        K = LinOpVStack([Convolve2D(shape, gaussian_kernel(), device=on), Gradient(shape)])
        return PDS(shape, G=NonNegativeOrthant(shape), H=H, K=K, x0=yy, max_iter=1000)

    return build, x_true, y


def salted_problem(shape, device):
    """Robust deblurring: the same blur of the peaks image with 5% of the
    pixels salted to 0 or to the maximum (``default_rng(18)``);
    ``PDS(G=NonNegativeOrthant, H=L1Loss(y), K=A)``."""
    from pycsou_tpu_torch.func import L1Loss, NonNegativeOrthant
    from pycsou_tpu_torch.ops import Convolve2D
    from pycsou_tpu_torch.opt import PDS

    x_true = peaks_image(shape, device)
    y = Convolve2D(shape, gaussian_kernel(), device=device).apply(x_true).cpu().numpy()
    rng = np.random.default_rng(18)
    salt = rng.random(shape) < 0.05
    y[salt] = np.where(rng.random(int(salt.sum())) < 0.5, 0.0, float(x_true.max()))
    y = torch.from_numpy(y).to(device)

    def build(on=device):
        A = Convolve2D(shape, gaussian_kernel(), device=on)
        return PDS(shape, G=NonNegativeOrthant(shape), H=L1Loss(shape, y.to(on)), K=A, max_iter=1000)

    return build, x_true, y


def group_lasso_problem(shape, device):
    """The group LASSO: 0.2% of the 8 x 8 tiles at 3.0 (``default_rng(19)``),
    ``y = A x_true + 0.01 noise``; ``APGD(F=SquaredL2Loss(y) * A, G=0.01 *
    L21Norm(groups=tile labels))``."""
    from pycsou_tpu_torch.func import L21Norm, SquaredL2Loss
    from pycsou_tpu_torch.ops import Convolve2D
    from pycsou_tpu_torch.opt import APGD

    rng = np.random.default_rng(19)
    tiles = tile_labels(shape)
    on = rng.random(int(tiles.max()) + 1) < 0.002
    x_true = torch.from_numpy(np.where(on[tiles], 3.0, 0.0).astype(np.float32)).to(device)
    noise = torch.from_numpy(0.01 * rng.standard_normal(shape).astype(np.float32)).to(device)
    y = Convolve2D(shape, gaussian_kernel(), device=device).apply(x_true) + noise

    def build(on=device):
        A = Convolve2D(shape, gaussian_kernel(), device=on)
        G = 0.01 * L21Norm(shape, groups=tiles, device=on)
        return APGD(shape, F=SquaredL2Loss(shape, y.to(on)) * A, G=G, max_iter=1000)

    return build, x_true, y


def tile_labels(shape):
    """The label of each pixel's ``TILE x TILE`` tile, row-major."""
    return (np.arange(shape[0])[:, None] // TILE) * (shape[1] // TILE) + np.arange(shape[1])[None, :] // TILE


def _rel_err(x, ref):
    return float(torch.linalg.vector_norm(x - ref) / torch.linalg.vector_norm(ref))


def prox_table(d):
    """``(name, thunk, tol, elementwise)`` of every new prox, projection and
    apply on the inputs ``d`` (``x`` N(0, 1), ``xpos`` = |N| + 1, ``z``
    complex64, all on one device), the functionals built there;
    ``elementwise`` marks the maps whose output at a pixel depends on that
    pixel alone (a band of rows of their input gives that band of their
    output)."""
    from pycsou_tpu_torch import func as f
    from pycsou_tpu_torch.math.prox import lambertw, proj_l1_ball

    x, xpos, z = d["x"], d["xpos"], d["z"]
    shape, n = tuple(x.shape), x.numel()
    sort, root = f.SquaredL1Norm(shape, "sort"), f.SquaredL1Norm(shape, "root")
    l2, l2b, linf = f.L2Norm(shape), f.L2Ball(shape, radius=1000.0), f.LInftyNorm(shape)
    linfb, seg, logb, ent = f.LInftyBall(shape, radius=1.0), f.Segment(shape, -0.5, 0.5), f.LogBarrier(shape), \
        f.ShannonEntropy(shape)
    kl = f.KLDivergence(shape, torch.flip(xpos, (1,)))
    l21 = f.L21Norm(shape, groups=tile_labels(shape), device=x.device)
    l1, sq = f.L1Norm(shape), f.SquaredL2Norm(shape)
    I, P = TOL_PROX_ITER, TOL_PROX
    return [
        ("proj_l1_ball", lambda: proj_l1_ball(x, 0.05 * n), I, False),
        ("SquaredL1Norm.prox 'sort'", lambda: sort.prox(x, 1e-8), I, False),
        ("SquaredL1Norm.prox 'root'", lambda: root.prox(x, 1e-8), I, False),
        ("SquaredL1Norm.apply", lambda: sort.apply(x), P, False),
        ("L2Norm.prox", lambda: l2.prox(x, 1000.0), P, False),
        ("L2Norm.apply", lambda: l2.apply(x), P, False),
        ("L2Ball.prox", lambda: l2b.prox(x, 1.0), P, False),
        ("LInftyNorm.prox", lambda: linf.prox(x, 0.05 * n), I, False),
        ("LInftyNorm.apply", lambda: linf.apply(x), P, False),
        ("LInftyBall.prox", lambda: linfb.prox(x, 1.0), P, True),
        ("Segment.prox", lambda: seg.prox(x, 1.0), P, True),
        ("LogBarrier.prox", lambda: logb.prox(x, 0.3), P, True),
        ("LogBarrier.apply", lambda: logb.apply(xpos), P, False),
        ("ShannonEntropy.prox", lambda: ent.prox(xpos, 0.7), I, True),
        ("ShannonEntropy.apply", lambda: ent.apply(xpos), P, False),
        ("KLDivergence.prox", lambda: kl.prox(xpos, 0.4), P, True),
        ("KLDivergence.apply", lambda: kl.apply(xpos), P, False),
        ("L21Norm(groups=).prox", lambda: l21.prox(x, 0.5), I, False),
        ("L21Norm(groups=).apply", lambda: l21.apply(x), I, False),
        ("lambertw", lambda: lambertw(20.0 * xpos), I, True),
        ("L1Norm.prox complex64", lambda: l1.prox(z, 0.5), P, True),
        ("SquaredL2Norm.apply complex64", lambda: sq.apply(z), P, False),
    ]


def phase_prox_sampling(dev, counters):
    """Phase 13: Poisson-TV deblurring, robust (L1) deblurring and the group
    LASSO at 4096^2 (launches, rates, idle shares, recovery; the first and
    the last against the CPU at 1024^2 after 20 iterations); every new prox,
    projection and apply at 4096^2 against the CPU, device-timed and run
    under the sync check; Pooling, NNSampling and GeneralisedVandermonde;
    examples/rbf_interpolation.py's two problems."""
    from pycsou_tpu_torch.func import SquaredL2Loss, SquaredL2Norm
    from pycsou_tpu_torch.math.green import Matern, Wendland
    from pycsou_tpu_torch.ops import GeneralisedVandermonde, MappedDistanceMatrix, NNSampling, Pooling
    from pycsou_tpu_torch.opt import APGD

    t_phase = t_mark = time.perf_counter()
    out = {"tolerances": {"prox": TOL_PROX, "prox_iterative": TOL_PROX_ITER, "cpu": TOL_PATH,
                          "sampling": TOL_REL, "adjoint": TOL_ADJOINT, "rbf_fit": TOL_RBF_FIT}}
    log(f"tolerances: {out['tolerances']}")

    def idle_share(solver, ips):
        busy = device_ms_per_iteration(solver)
        return None if busy is None else 1.0 - busy * ips / 1e3

    sections = out["section_s"] = {}

    def section(name):
        """The wall seconds since the last section ended, kept under ``name``."""
        nonlocal t_mark
        now = time.perf_counter()
        sections[name] = now - t_mark
        t_mark = now

    def against_cpu(name, problem, keys):
        """20 iterations at SHAPE_P13_CPU on the card and on the CPU, on the same data."""
        build = problem(SHAPE_P13_CPU, dev)[0]
        st_d, st_c = build().run_fixed(20), build("cpu").run_fixed(20)
        scale = max(1.0, float(st_c["x"].abs().max()))
        err = max(float((st_d[k].cpu() - st_c[k]).abs().max()) for k in keys)
        log(f"{name} at {SHAPE_P13_CPU[0]}^2 after 20 iterations: card against CPU max abs err {err:.3e} "
            f"(tol {TOL_PATH:g} x {scale:.3f})")
        if err > TOL_PATH * scale:
            raise AssertionError(f"{name}: the card disagrees with the CPU")
        return err

    # -- the three solver paths at 4096^2
    paths = (("Poisson-TV", poisson_tv_problem, {"K1": 400}, 200, ("x", "z")),
             ("L1 robust", salted_problem, {"K1": 400}, 200, None),
             ("group LASSO", group_lasso_problem, {"K2": 100}, 100, ("x", "x_temp")))
    for name, problem, exact, n_it, cpu_keys in paths:
        build, x_true, y = problem(SHAPE, dev)
        section(f"{name} data")
        solver, build_counts = count_launches(counters, build)
        st, counts = count_launches(counters, lambda: solver.run_fixed(n_it))
        section(f"{name} build and run")
        log(f"{name} at {SHAPE[0]}^2: {type(solver).__name__} fused={solver._fused is not None}; construction "
            f"launches {build_counts}; {n_it} iterations: launches {counts}")
        if solver._fused is not None:
            raise AssertionError(f"{name}: fused, where the generic chain must run")
        expect_launches(name, counts, exact)
        x = st["x"]
        if tuple(x.shape) != SHAPE or not bool(torch.isfinite(x).all()):
            raise AssertionError(f"{name}: x is not a finite {SHAPE[0]}^2 image")
        rec = {"construction_launches": {k: v for k, v in build_counts.items() if v},
               "launches": {k: v for k, v in counts.items() if v}, "iterations": n_it,
               "rel_err": _rel_err(x, x_true), "observation_rel_err": _rel_err(y, x_true)}
        if not rec["rel_err"] < rec["observation_rel_err"]:
            raise AssertionError(f"{name}: recovery {rec['rel_err']:.4f} no better than the observation's "
                                 f"{rec['observation_rel_err']:.4f}")
        rec["iters_per_s"] = time_solver(solver)
        rec["device_idle_share"] = idle_share(solver, rec["iters_per_s"])
        section(f"{name} rate")
        if cpu_keys:
            rec["max_abs_err_cpu_20"] = against_cpu(name, problem, cpu_keys)
        log(f"{name}: relative error {rec['rel_err']:.4f} against the observation's "
            f"{rec['observation_rel_err']:.4f}; {rec['iters_per_s']:.1f} iters/s, device idle share "
            f"{rec['device_idle_share']}")
        out[name] = rec
        del solver, st, x_true, y
        section(f"{name} against the CPU")

    # -- every new prox, projection and apply at 4096^2, against the CPU, under the sync check
    g = torch.Generator(device=dev)
    g.manual_seed(17)
    x = torch.randn(SHAPE, generator=g, device=dev)
    xpos = torch.randn(SHAPE, generator=g, device=dev).abs() + 1.0
    z = torch.complex(torch.randn(SHAPE, generator=g, device=dev), torch.randn(SHAPE, generator=g, device=dev))
    on_dev = {"x": x, "xpos": xpos, "z": z}
    band = SHAPE[0] // PROX_BAND
    tables = (prox_table(on_dev), prox_table({k: v.cpu() for k, v in on_dev.items()}),
              prox_table({k: v[:band].cpu() for k, v in on_dev.items()}))
    table = {}
    cpu_s = 0.0
    for (name, fn, tol, elementwise), (_, fn_cpu, _, _), (_, fn_band, _, _) in zip(*tables):
        ms = median_ms(fn)
        got = no_sync(fn)
        t0 = time.perf_counter()
        want = fn_band() if elementwise else fn_cpu()
        cpu_s += time.perf_counter() - t0
        got = got[:band] if elementwise else got
        err = float((got.cpu() - want).abs().max()) / max(1.0, float(want.abs().max()))
        table[name] = {"ms": ms, "rel_err_cpu": err, "tol": tol, "cpu_rows": band if elementwise else SHAPE[0]}
        log(f"{name} at {SHAPE[0]}^2: {ms:.4f} ms, against the CPU {err:.3e} (tol {tol:g}; "
            f"{'the first ' + str(band) + ' rows' if elementwise else 'every row'}), no host sync")
        if not err <= tol:
            raise AssertionError(f"{name}: the card disagrees with the CPU")
    del tables
    out["prox"] = table
    sections["prox table, CPU references"] = cpu_s
    section("prox table")
    del x, xpos, z, on_dev

    # -- the sampling operators
    def check_sampler(name, op, op_cpu, x, y, adjoint=True):
        ax, ahy = op.apply(x), op.adjoint(y)
        rec = {"apply_ms": median_ms(lambda: op.apply(x)), "adjoint_ms": median_ms(lambda: op.adjoint(y))}
        if adjoint:  # NNSampling's 'mean' mode is no adjoint: only the CPU check holds
            rec["adjoint_identity"] = float((torch.vdot(y.reshape(-1), ax.reshape(-1)) - torch.vdot(
                ahy.reshape(-1), x.reshape(-1))).abs() / (torch.linalg.vector_norm(ax) * torch.linalg.vector_norm(y)))
        rec["rel_err_cpu"] = max(max_err(ax.cpu(), op_cpu.apply(x.cpu()))[1],
                                 max_err(ahy.cpu(), op_cpu.adjoint(y.cpu()))[1])
        log(f"{name}: apply {rec['apply_ms']:.4f} ms, adjoint {rec['adjoint_ms']:.4f} ms; adjoint identity "
            f"{rec.get('adjoint_identity')} (tol {TOL_ADJOINT:g}); against the CPU {rec['rel_err_cpu']:.3e} "
            f"(tol {TOL_REL:g} x max(1, max))")
        if rec.get("adjoint_identity", 0.0) > TOL_ADJOINT or rec["rel_err_cpu"] > TOL_REL:
            raise AssertionError(f"{name}: the adjoint identity or the CPU check fails")
        return rec

    for kind in ("sum", "mean"):
        P = Pooling(SHAPE, (4, 4), kind=kind)
        xs = torch.randn(SHAPE, generator=g, device=dev)
        ys = torch.randn(P.codim_shape, generator=g, device=dev)
        out[f"Pooling {kind}"] = check_sampler(f"Pooling({SHAPE}, (4, 4), {kind!r})", P, P, xs, ys)
    rng = np.random.default_rng(21)
    gl = np.linspace(0, 1, NN_GRID[0])
    gx, gy = np.meshgrid(gl, gl, indexing="ij")
    t0 = time.perf_counter()
    nn = NNSampling(np.stack([gx.ravel(), gy.ravel()], 1), rng.uniform(0, 1, (NN_SAMPLES, 2)), dim_shape=NN_GRID,
                    device=dev)
    build_s = time.perf_counter() - t0
    xs = torch.randn(NN_GRID, generator=g, device=dev)
    ys = torch.randn(NN_SAMPLES, generator=g, device=dev)
    for mode in ("mean", "sum"):
        op = nn.replace(adjoint_mode=mode)
        op_cpu = op.replace(indices=op.indices.cpu(), counts=op.counts.cpu())
        rec = check_sampler(f"NNSampling {NN_SAMPLES} samples on {NN_GRID}, {mode!r}", op, op_cpu, xs, ys,
                            adjoint=mode == "sum")
        rec["build_s"] = build_s
        out[f"NNSampling {mode}"] = rec
    zs = rng.uniform(-1, 1, N_SAMPLES)
    monos = [lambda t, k=k: t**k for k in range(VDM_DEGREE + 1)]
    V, V_cpu = GeneralisedVandermonde(monos, zs, device=dev), GeneralisedVandermonde(monos, zs, device="cpu")
    xs = torch.randn(VDM_DEGREE + 1, generator=g, device=dev)
    ys = torch.randn(N_SAMPLES, generator=g, device=dev)
    out["GeneralisedVandermonde"] = check_sampler(
        f"GeneralisedVandermonde, degree <= {VDM_DEGREE}, {N_SAMPLES} samples", V, V_cpu, xs, ys)
    section("sampling operators")
    del nn, V, V_cpu, xs, ys

    # -- examples/rbf_interpolation.py main(): dense Matern fit to 1e-8, card against CPU
    def rbf_main(device):
        r = np.random.default_rng(0)
        t_obs = np.sort(r.uniform(0, 1, 120)).astype(np.float32)
        f_true = lambda t: np.sin(6 * np.pi * t) * np.exp(-t)  # noqa: E731
        yv = (f_true(t_obs) + 0.05 * r.standard_normal(120).astype(np.float32)).astype(np.float32)
        centers = np.linspace(0, 1, 60).astype(np.float32)
        K = MappedDistanceMatrix(t_obs, centers, Matern(k=2, epsilon=0.08), device=device)
        K.compute_lipschitz_cst()
        info = APGD((60,), F=SquaredL2Loss((120,), yv, device=device) * K, G=0.05 * SquaredL2Norm((60,)),
                    max_iter=2000, accuracy_threshold=1e-8).solve()
        t_grid = np.linspace(0, 1, 512).astype(np.float32)
        K_grid = MappedDistanceMatrix(t_grid, centers, Matern(k=2, epsilon=0.08), device=device)
        f_hat = K_grid.apply(info["x_temp"]).cpu().numpy()
        return (float(np.linalg.norm(f_hat - f_true(t_grid)) / np.linalg.norm(f_true(t_grid))), info.n_iter,
                K.lipschitz, info.elapsed)

    fit_d, it_d, lip_d, el_d = rbf_main(dev)
    fit_c, it_c, lip_c, _ = rbf_main("cpu")
    out["rbf main"] = {"fit_rel_err": fit_d, "cpu_fit_rel_err": fit_c, "n_iter": it_d, "cpu_n_iter": it_c,
                       "lipschitz": lip_d, "cpu_lipschitz": lip_c, "solve_s": el_d}
    log(f"rbf main(): ||K|| {lip_d:.4f} (CPU {lip_c:.4f}), {it_d} iterations (CPU {it_c}) in {el_d:.3f} s, "
        f"fit error {fit_d:.5f} against the CPU's {fit_c:.5f} (tol {TOL_RBF_FIT:g})")
    if not abs(fit_d - fit_c) <= TOL_RBF_FIT:
        raise AssertionError("rbf main(): the card's fit disagrees with the CPU's")
    section("rbf main")

    # -- main_large(): 50,000 points, Wendland, the sparse backend
    r = np.random.default_rng(1)
    pts = r.uniform(size=(RBF_N, 2)).astype(np.float32)
    f_true2 = np.sin(4 * np.pi * pts[:, 0]) * np.cos(3 * np.pi * pts[:, 1])
    y2 = (f_true2 + 0.02 * r.standard_normal(RBF_N).astype(np.float32)).astype(np.float32)
    t0 = time.perf_counter()
    K = MappedDistanceMatrix(pts, pts, Wendland(k=2, epsilon=0.02), backend="sparse", device=dev)
    build_s = time.perf_counter() - t0
    kmax = int(K._nbr_idx.shape[1])
    t0 = time.perf_counter()
    K.compute_lipschitz_cst(maxiter=32)
    lip_s = time.perf_counter() - t0

    def rbf_large(op, device):
        return APGD((RBF_N,), F=SquaredL2Loss((RBF_N,), y2, device=device) * op,
                    G=1e-3 * SquaredL2Norm((RBF_N,)), max_iter=200, accuracy_threshold=1e-6)

    solver = rbf_large(K, dev)
    st = solver.run_fixed(200)
    f_hat = K.apply(st["x_temp"]).cpu().numpy()
    fit = float(np.linalg.norm(f_hat - f_true2) / np.linalg.norm(f_true2))
    ips = time_solver(solver)
    K_cpu = K.replace(samples1=K.samples1.cpu(), samples2=K.samples2.cpu(), _nbr_idx=K._nbr_idx.cpu(),
                      _nbr_val=K._nbr_val.cpu())  # the same neighbour lists, on the CPU
    st_d, st_c = solver.run_fixed(20), rbf_large(K_cpu, "cpu").run_fixed(20)
    scale = max(1.0, float(st_c["x"].abs().max()))
    err = max(float((st_d[k].cpu() - st_c[k]).abs().max()) for k in ("x", "x_temp"))
    rec = {"kmax": kmax, "build_s": build_s, "lipschitz": K.lipschitz, "lipschitz_s": lip_s, "fit_rel_err_200": fit,
           "iters_per_s": ips, "device_idle_share": idle_share(solver, ips), "max_abs_err_cpu_20": err}
    log(f"rbf main_large(): n {RBF_N}, kmax {kmax}, built in {build_s:.2f} s, ||K|| {K.lipschitz:.4f} in "
        f"{lip_s:.2f} s; 200 iterations: fit error {fit:.4f}; {ips:.1f} iters/s, device idle share "
        f"{rec['device_idle_share']}; after 20 card against CPU {err:.3e} (tol {TOL_PATH:g} x {scale:.3f})")
    if err > TOL_PATH * scale or not math.isfinite(fit):
        raise AssertionError("rbf main_large(): the card disagrees with the CPU")
    Kmf = MappedDistanceMatrix(pts, pts, Wendland(k=2, epsilon=0.02), backend="matrix-free", block=2048, device=dev)
    xv = torch.randn(RBF_N, generator=g, device=dev)

    def chained(op, n):
        v = xv
        for _ in range(n):
            v = op.apply(v)
        return v

    rec["sparse_matvec_ms"] = wall_ms(lambda: chained(K, 5)) / 5
    rec["matrix_free_matvec_ms"] = wall_ms(lambda: chained(Kmf, 2), reps=3) / 2
    rec["sparse_vs_matrix_free_rel_err"] = _rel(K.apply(xv), Kmf.apply(xv))
    log(f"rbf main_large() chained matvec: sparse {rec['sparse_matvec_ms']:.4f} ms, matrix-free (block 2048) "
        f"{rec['matrix_free_matvec_ms']:.3f} ms; the two agree to {rec['sparse_vs_matrix_free_rel_err']:.3e}")
    if rec["sparse_vs_matrix_free_rel_err"] > TOL_PROX_ITER:
        raise AssertionError("rbf main_large(): the sparse and matrix-free backends disagree")
    out["rbf main_large"] = rec
    section("rbf main_large")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"proximal calculus, sampling and RBF: {out['seconds']:.1f} s; by section "
        + ", ".join(f"{k} {v:.1f}" for k, v in sections.items()))
    return out


SHAPE_P14_CPU = (1024, 1024)  # phase 14's card-against-CPU runs
N_P14 = 20  # iterations of each phase-14 comparison with one device
N_P14_CPU = 10  # and with the CPU
TOL_P14_CPU = 1e-5  # the card against the port's CPU run, x max(1, max |x|)
TOL_OBJ = 1e-5  # the last obj_history entry against objective(x) afterwards, relative
P14_DIR = "build/phase14"  # checkpoints and the trace, inside the checkout, removed after


def phase_solver_io_chain(dev, counters, res):
    """Phase 14: the solver's checkpoint, objective, iterates and profiling
    on the main path at 4096^2, and the sharded chain (four 1024-row shards
    on one card): sweepsp over the sharded FFT Gram with a 17 x 17
    full-rank PSF, the band chain and the diagonal chain (use_pallas=False),
    the mask on a (2, 2) 2-D mesh, BatchedDistributedTVDeconv2D on a (2, 2)
    (dp, sp) mesh; each against TVDeconvolution on one device after N_P14
    iterations, timed, and the full-rank case and the batch against the CPU
    at 1024^2 after N_P14_CPU."""
    import shutil
    from pathlib import Path

    from scipy.signal import fftconvolve

    from pycsou_tpu_torch.func import L21Norm, NonNegativeOrthant, SquaredL2Loss
    from pycsou_tpu_torch.kernels.tv import tv_pds_sweep_shard_step
    from pycsou_tpu_torch.ops import Convolve2D, Gradient
    from pycsou_tpu_torch.opt import PDS, TVDeconvolution
    from pycsou_tpu_torch.parallel import (BatchedDistributedTVDeconv2D, DistributedTVDeconv2D,
                                           Spatial2DTVDeconv2D, halos, make_mesh)
    from pycsou_tpu_torch.utils import checkpoint, profiling

    t_phase = t_mark = time.perf_counter()
    sections = {}

    def section(name):
        nonlocal t_mark
        now = time.perf_counter()
        sections[name] = now - t_mark
        t_mark = now
    root = Path(__file__).resolve().parent / P14_DIR
    shutil.rmtree(root, ignore_errors=True)
    out = {"tolerances": {"path": TOL_PATH, "cpu": TOL_P14_CPU, "objective": TOL_OBJ}}
    rng = np.random.default_rng(SEED + 14)
    h, x_true, y = make_problem(rng, SHAPE)
    yt = torch.from_numpy(y).to(dev)

    def pds(n, **kw):
        return PDS(SHAPE, F=SquaredL2Loss(SHAPE, data=yt) * Convolve2D(SHAPE, h, device=dev),
                   G=NonNegativeOrthant(SHAPE), H=LAM * L21Norm((2,) + SHAPE, axis=0), K=Gradient(SHAPE),
                   max_iter=n, min_iter=n, accuracy_threshold=0.0, **kw)

    def idle_share(solver, ips):
        busy = device_ms_per_iteration(solver)
        return None if busy is None else 1.0 - busy * ips / 1e3

    # (a) resume: 200 iterations saved, a fresh solver resumes to 400
    ck = str(root / "ckpt")
    first = pds(200).solve(checkpoint_dir=ck, checkpoint_every=1)
    names_first = [Path(p).name for p in checkpoint.checkpoint_steps(ck)]
    resumed = pds(400).solve(checkpoint_dir=ck, checkpoint_every=1)
    names = sorted((Path(p).name for p in checkpoint.checkpoint_steps(ck)), key=lambda n: int(n[5:]))
    whole = pds(400).solve()
    diff = float((resumed["x"] - whole["x"]).abs().max())
    solver = pds(400)
    template = solver._wrap_state(solver.initial_state())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = checkpoint.load_state(f"{ck}/step_200", template=template)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    checkpoint.save_state(str(root / "timing" / "step_200"), state)
    save_s = time.perf_counter() - t0
    mb = sum(t.numel() * t.element_size() for t in (state["x"], state["z0"], state["z1"])) / 1e6
    out["resume"] = {"engine": solver._fused.stencil_mode, "first_n_iter": first.n_iter, "n_iter": resumed.n_iter,
                     "steps_after_first": names_first, "steps": names, "max_abs_diff": diff,
                     "save_s": save_s, "load_s": load_s, "state_mb": mb}
    log(f"resume: PDS -> TVDeconvolution[{solver._fused.stencil_mode}] 200 iterations saved as {names_first}, "
        f"a fresh solver resumed to {resumed.n_iter} (saves {names}); max |x - uninterrupted x| = {diff:.3e}; "
        f"one save {save_s:.3f} s, one load {load_s:.3f} s of the {mb:.1f} MB state (x, z0, z1)")
    if diff != 0.0 or resumed.n_iter != 400 or names != ["step_100", "step_200", "step_300", "step_400"]:
        raise AssertionError("the resumed solve differs from the uninterrupted one")
    shutil.rmtree(root / "timing")
    del first, resumed, whole, state, template
    section("resume")

    # (b) the objective: rates with and without track_objective, no host sync
    plain, tracked = pds(3000), pds(3000)
    tracked.track_objective = True
    rec = {}
    for name, s_ in (("without", plain), ("with", tracked)):
        ips = time_solver(s_)
        rec[name] = {"iters_per_s": ips, "device_idle_share": idle_share(s_, ips)}
    st = tracked.run_fixed(2)
    st = no_sync(lambda: tracked.run_fixed(ITERS, state=st))
    last = float(st["obj_history"][st["it"] - 1])
    direct = float(tracked.objective(st["x"]))
    rec["last_obj_history"], rec["objective_after"] = last, direct
    rec["rel_diff"] = abs(last - direct) / abs(direct)
    rec["cost"] = 1.0 - rec["with"]["iters_per_s"] / rec["without"]["iters_per_s"]
    out["track_objective"] = rec
    log(f"track_objective: {rec['without']['iters_per_s']:.1f} iters/s without (idle share "
        f"{rec['without']['device_idle_share']}), {rec['with']['iters_per_s']:.1f} with (idle share "
        f"{rec['with']['device_idle_share']}): cost {100 * rec['cost']:.1f}%; run_fixed({ITERS}) with it made no host "
        f"sync; last obj_history {last:.6e} vs objective(x) {direct:.6e} (rel {rec['rel_diff']:.2e}, tol {TOL_OBJ:g})")
    if not rec["rel_diff"] <= TOL_OBJ:
        raise AssertionError("obj_history's last entry is not the objective at x")
    del st
    section("track_objective")

    # (c) iterates(100, stride=20) against run_fixed(20 k)
    it_solver = pds(3000)
    ys = [o["x"] for o in it_solver.iterates(100, stride=20)]
    diffs = [float((yk - it_solver.run_fixed(20 * (k + 1))["x"]).abs().max()) for k, yk in enumerate(ys)]
    out["iterates_max_abs_diff"] = diffs
    log(f"iterates(100, stride=20): {len(ys)} yields; max |yield_k - run_fixed(20 k) x| = {diffs}")
    if len(ys) != 5 or any(d != 0.0 for d in diffs):
        raise AssertionError("iterates() differs from run_fixed()")
    del ys

    # (d) profiling: a trace of 20 iterations inside annotate("phase14")
    st = it_solver.run_fixed(2)
    torch.cuda.synchronize()
    with profiling.trace(str(root / "trace")), profiling.annotate("phase14"):
        it_solver.run_fixed(20, state=st)
        torch.cuda.synchronize()
    with open(root / "trace" / "trace.json") as f:
        names_in_trace = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    k10 = sorted(n for n in names_in_trace if "mega3" in n)
    dt = profiling.device_time(it_solver.run_fixed, 20, reps=5)
    out["profiling"] = {"k10_kernel_names": k10, "span": "phase14" in names_in_trace, "device_time_20_s": dt}
    log(f"profiling.trace: kernels named {k10}, span 'phase14' {'phase14' in names_in_trace}; "
        f"device_time(run_fixed(20)) = {dt * 1e3:.3f} ms")
    if not k10 or "phase14" not in names_in_trace:
        raise AssertionError("the trace lacks K10's kernel or the phase14 span")
    shutil.rmtree(root, ignore_errors=True)
    del st
    section("iterates, profiling")

    # (e), (f) the sharded chain against TVDeconvolution on one device
    mesh = make_mesh((SHARDS,), devices=[dev] * SHARDS)
    h17 = fullrank_kernel(FULLRANK_FFT_K)
    y17 = torch.from_numpy((fftconvolve(x_true, h17, mode="same")
                            + 0.01 * rng.standard_normal(SHAPE)).astype(np.float32)).to(dev)
    m = torch.from_numpy(keep_mask(SHAPE).astype(np.float32)).to(dev)
    y2 = torch.stack([yt, torch.flip(yt, (0,))])
    cases = {
        "sweepsp full rank 17x17": (lambda: DistributedTVDeconv2D(SHAPE, h17, y17, LAM, mesh=mesh, max_iter=3000),
                                    {"K16": SHARDS * N_P14}, (y17, h17, None)),
        "band chain (Gaussian)": (lambda: DistributedTVDeconv2D(SHAPE, h, yt, LAM, mesh=mesh, use_pallas=False,
                                                                max_iter=3000), {}, (yt, h, None)),
        "diagonal chain (mask)": (lambda: DistributedTVDeconv2D(SHAPE, None, m * yt, LAM, mesh=mesh, mask=m,
                                                                use_pallas=False, max_iter=3000), {},
                                  (m * yt, None, m)),
        "2-D mesh mask chain": (lambda: Spatial2DTVDeconv2D(SHAPE, None, m * yt, LAM, mask=m, max_iter=3000,
                                                            mesh=make_mesh(MESH2D, ("sp0", "sp1"), [dev] * 4)),
                                {}, (m * yt, None, m)),
        "batch (dp, sp) = (2, 2)": (lambda: BatchedDistributedTVDeconv2D(
            SHAPE, h, y2, LAM, mesh=make_mesh((2, 2), ("dp", "sp"), [dev] * 4), max_iter=3000), {}, None),
    }
    chain = {}
    for name, (build, exact, single) in cases.items():
        (solver, st), counts = count_launches(counters, built_and_run(build, n=N_P14))
        expect_launches(name, counts, exact)
        x = solver.postprocess(st)["x"]
        refs = []
        for k, (yy, ff, mm) in enumerate([single] if single else [(y2[0], h, None), (y2[1], h, None)]):
            ref = TVDeconvolution(SHAPE, yy, LAM, filt=ff, mask=mm, tau=solver.tau, sigma=solver.sigma,
                                  rho=solver.rho, max_iter=3000).run_fixed(N_P14)
            refs.append((ref, x if single else x[k]))
        errs = [max_err(got, ref["x"])[0] for ref, got in refs]
        scale = max(max(1.0, float(ref["x"].abs().max())) for ref, _ in refs)
        engine = getattr(solver, "_sp_engine", "") or "chain"
        route = ("band Gram" if getattr(solver, "_use_band", False) else "FFT Gram"
                 if getattr(solver, "_use_gram", False) else "mask")
        if name.startswith("batch"):
            route = "band Gram" if solver._inners[0]._use_band else "FFT Gram"
        ips = time_solver(solver, n_short=5, n_long=25, reps=2)
        rec = {"engine": engine, "route": route, "launches": counts, "max_abs_err": errs, "tol": TOL_PATH * scale,
               "iters_per_s": ips, "device_idle_share": idle_share(solver, ips)}
        chain[name] = rec
        log(f"{name}: {type(solver).__name__}[{engine}, {route}] {N_P14} iterations, launches {counts}; "
            f"against TVDeconvolution on one device max |dx| {errs} (tol {TOL_PATH:g} x {scale:.3f}); "
            f"{ips:.1f} iters/s slope-timed, device idle share {rec['device_idle_share']}")
        if any(e > TOL_PATH * scale for e in errs):
            raise AssertionError(f"{name} disagrees with TVDeconvolution on one device")
        if name.startswith("sweepsp"):
            # K16 on this path: a middle shard's launch at the path's inputs
            x_s = st["x"]
            g = tuple(solver._data_grad(x_s, solver.atb, solver.y))
            hl = halos((x_s, g, st["z0"], st["z1"]), 1)
            kw = dict(H_global=SHAPE[0], tau=solver.tau, sigma=solver.sigma, rho=solver.rho, lam=LAM)
            i = 1
            rec["k16_shard_ms"] = median_ms(lambda: tv_pds_sweep_shard_step(
                x_s[i], g[i], st["z0"][i], st["z1"][i], hl[i], i * solver.h_loc - 1, **kw))
            res["K16"]["fft_gram_path_launches"] = counts["K16"]
            res["K16"]["fft_gram_path_shard_ms"] = rec["k16_shard_ms"]
            log(f"K16 on the FFT-Gram path: {counts['K16']} launches in {N_P14} iterations, "
                f"{rec['k16_shard_ms']:.4f} ms a shard launch")
        del solver, st, x, refs
    out["chain"] = chain
    section("chain")

    # (h) the card against the port's CPU run at 1024^2
    Hc = SHAPE_P14_CPU
    yc = (fftconvolve(x_true[: Hc[0], : Hc[1]], h17, mode="same")).astype(np.float32)
    yb = np.stack([y[: Hc[0], : Hc[1]], y[-Hc[0]:, -Hc[1]:]]).astype(np.float32)
    cpu = torch.device("cpu")
    builds = {
        "sweepsp full rank 17x17": lambda d: DistributedTVDeconv2D(
            Hc, h17, yc, LAM, mesh=make_mesh((SHARDS,), devices=[d] * SHARDS),
            use_pallas="auto" if d.type == "cuda" else "interpret"),
        "batch (dp, sp) = (2, 2)": lambda d: BatchedDistributedTVDeconv2D(
            Hc, h, yb, LAM, mesh=make_mesh((2, 2), ("dp", "sp"), [d] * 4)),
    }
    vs_cpu = {}
    for name, build in builds.items():
        card, host = build(dev), build(cpu)
        xg = card.postprocess(card.run_fixed(N_P14_CPU))["x"].cpu()
        xc = host.postprocess(host.run_fixed(N_P14_CPU))["x"]
        e, rel = max_err(xg, xc)
        vs_cpu[name] = {"max_abs_err": e, "rel": rel}
        log(f"{name} at {Hc[0]}^2: card against CPU after {N_P14_CPU} iterations: max |dx| {e:.3e} "
            f"({rel:.3e} of max(1, max |x|), tol {TOL_P14_CPU:g})")
        if rel > TOL_P14_CPU:
            raise AssertionError(f"{name}: the card disagrees with the CPU")
    out["vs_cpu"] = vs_cpu
    section("against the CPU")
    out["seconds"], out["section_s"] = time.perf_counter() - t_phase, sections
    log(f"phase 14: {out['seconds']:.1f} s; by section " + ", ".join(f"{k} {v:.1f}" for k, v in sections.items()))
    return out


N_P15 = 20  # iterations of each routed case (K14-K17: SHARDS launches each)
N_DENSE_P15 = 16384  # ShardedDenseOperator's matrix: 16384^2 f32, 1 GiB
SHAPE_BLOCK_P15 = (1024, 1024)  # ShardedBlockDiagonalOperator's band Convolve2D blocks
N_BLOCKS_P15 = 8
N_PENCIL_APGD = 50  # the circular deconvolution through APGD.with_shardings
N_MCMC_P15 = 20  # PMYULA samples of the twin
TOL_OP_P15 = 1e-5  # a mesh operator against its single-device counterpart, x max |out|
HBM_MEASURED_BYTES_PER_S = 2988.6e9  # the card's copy rate measured in phase 1 (PERF.md): context, not a floor


def slope_ms(fn, n_short=5, n_long=25):
    """Wall ms of one call of ``fn``, slope-timed: ``n_long`` and
    ``n_short`` calls, each run synchronised, their difference over the
    difference of the counts (the constant cost cancels)."""
    fn()
    torch.cuda.synchronize()
    out = []
    for n in (n_short, n_long):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return 1e3 * (out[1] - out[0]) / (n_long - n_short)


def phase_sharded_entry(dev, counters):
    """Phase 15: the sharded entry points at full width on one card.  (a)
    ``PDS.with_shardings`` routes the main path (K14), the rank-2 PSF
    (K15), inpainting (K16) on a 4-position mesh and the main path on a
    (2, 2) mesh (K17), each launching its kernel SHARDS x N_P15 times in
    N_P15 iterations, bit for bit the hand-built solver and within TOL_PATH
    of ``TVDeconvolution`` on one device; (b) tau != sigma and combined
    mode take the generic chain with a warning and no shard kernel, and a
    constructor's RuntimeError propagates; (c) the twins:
    ``TVDeconvolution.with_shardings`` on mega2 (K11) and, for the rank-2
    PSF, megar (K4), ``PMYULA`` without K9,
    the LASSO ``APGD`` without K8; (d) ``ShardedDenseOperator`` at 16384^2;
    (e) ``ShardedBlockDiagonalOperator`` of 8 band ``Convolve2D``s (K1);
    (f) ``PencilCircularConv2D`` at 4096^2 and a circular deconvolution by
    ``APGD.with_shardings``; (g) ``distributed_init()`` of one process; (h)
    the rates, routed and hand-built alternately."""
    import logging

    from scipy.signal import fftconvolve

    from pycsou_tpu_torch.func import L1Norm, L21Norm, NonNegativeOrthant, SquaredL2Loss
    from pycsou_tpu_torch.ops import CircularConvolve, Convolve2D, Gradient, Masking
    from pycsou_tpu_torch.opt import APGD, PDS, PMYULA, TVDeconvolution
    from pycsou_tpu_torch.opt.admm import stack_operators
    from pycsou_tpu_torch.parallel import (DistributedTVDeconv2D, NamedSharding, PartitionSpec,
                                           PencilCircularConv2D, ShardedBlockDiagonalOperator,
                                           ShardedDenseOperator, Spatial2DTVDeconv2D, distributed_init,
                                           make_mesh, shard_along, solvers)
    from pycsou_tpu_torch.utils.device import full_f32

    t_phase = t_mark = time.perf_counter()
    sections = {}

    def section(name):
        nonlocal t_mark
        now = time.perf_counter()
        sections[name] = now - t_mark
        t_mark = now

    out = {"tolerances": {"path": TOL_PATH, "operators": TOL_OP_P15}}
    rng = np.random.default_rng(SEED + 15)
    h, _, y = make_problem(rng, SHAPE)
    yt = torch.from_numpy(y).to(dev)
    h2 = rank2_kernel()
    y2 = torch.from_numpy(fftconvolve(np.abs(rng.standard_normal(SHAPE)), h2, mode="same").astype(np.float32)).to(dev)
    keep = keep_mask(SHAPE)
    M = Masking(SHAPE, keep, device=dev)
    y_in = M(yt)
    mesh = make_mesh((SHARDS,), devices=[dev] * SHARDS)
    mesh2 = make_mesh(MESH2D, ("sp0", "sp1"), devices=[dev] * (MESH2D[0] * MESH2D[1]))
    rows, grid = shard_along(mesh, "sp", 2, 0), NamedSharding(mesh2, PartitionSpec("sp0", "sp1"))

    def tv_pds(op, data, **kw):
        return PDS(SHAPE, F=SquaredL2Loss(op.codim_shape, data=data) * op, G=NonNegativeOrthant(SHAPE),
                   H=LAM * L21Norm((2,) + SHAPE, axis=0), K=Gradient(SHAPE), max_iter=3000, **kw)

    def conv(psf):
        return Convolve2D(SHAPE, psf, device=dev)

    def idle_share(solver, ips):
        busy = device_ms_per_iteration(solver)
        return None if busy is None else 1.0 - busy * ips / 1e3

    # (a) routing: name -> (expression, sharding, delegate class, engine, kernel, K1 launches, single engine)
    cases = {
        "main path -> megasp": (lambda: tv_pds(conv(h), yt), rows, DistributedTVDeconv2D, "megasp", "K14",
                                SHARDS, "mega2"),
        "rank-2 PSF -> megarsp": (lambda: tv_pds(conv(h2), y2), rows, DistributedTVDeconv2D, "megarsp", "K15",
                                  SHARDS, "megar"),
        "inpainting -> sweepsp": (lambda: tv_pds(M, y_in), rows, DistributedTVDeconv2D, "sweepsp", "K16", 0,
                                  "sweepm"),
        "main path (2, 2) -> megar2d": (lambda: tv_pds(conv(h), yt), grid, Spatial2DTVDeconv2D, "megar2d", "K17",
                                        SHARDS, "megar"),
    }
    routed_runs, routed = {}, {}
    for name, (build, sh, cls, engine, kernel, k1, single) in cases.items():
        pds = build()

        def route_and_run(pds=pds, sh=sh):
            s = pds.with_shardings(x=sh)
            return s, s.run_fixed(N_P15)

        (s, st), counts = count_launches(counters, route_and_run)
        d = s._fused
        if type(d) is not cls or d._sp_engine != engine or s.iters_per_step != 1:
            raise AssertionError(f"{name}: routed onto {type(d).__name__}[{getattr(d, '_sp_engine', None)}]")
        exact = {kernel: SHARDS * N_P15, **({"K1": k1} if k1 else {})}
        log(f"{name}: PDS.with_shardings -> {cls.__name__}[{engine}] run for {st['it']} iterations; "
            f"launches {counts}")
        expect_launches(name, counts, exact)
        fused = pds._fused
        kw = dict(tau=fused.tau, rho=pds.rho, max_iter=3000)
        hand = cls(SHAPE, fused.filt, fused.y, LAM, mesh=mesh2 if cls is Spatial2DTVDeconv2D else mesh,
                   mask=fused.mask, **kw)
        x = s.postprocess(st)["x"]
        x_hand = hand.postprocess(hand.run_fixed(N_P15))["x"]
        same = bool(torch.equal(x, x_hand))
        ref = TVDeconvolution(SHAPE, fused.y, LAM, filt=fused.filt, mask=fused.mask, stencil=single, tau=fused.tau, sigma=fused.sigma,
                              max_iter=3000).run_fixed(N_P15)["x"]
        err = max_err(x, ref)[0]
        scale = max(1.0, float(ref.abs().max()))
        log(f"{name}: routed x bit for bit the hand-built {cls.__name__}: {same}; against "
            f"TVDeconvolution[{single}] after {N_P15}: max |dx| {err:.3e} (tol {TOL_PATH:g} x {scale:.3f})")
        if not same or err > TOL_PATH * scale:
            raise AssertionError(f"{name}: the routed solve disagrees with the hand-built or one-device solver")
        routed_runs[kernel] = {"run": name, "launches": counts[kernel]}
        routed[name] = (s, hand)
        del st, x, x_hand, ref
    out["routed"] = routed_runs
    section("routing")

    # (b) declines, and an error that is not a gate
    class Catch(logging.Handler):
        def __init__(self):
            super().__init__()
            self.messages = []

        def emit(self, record):
            self.messages.append(record.getMessage())

    catch = Catch()
    flog = logging.getLogger("pycsou_tpu_torch.fuse")
    flog.addHandler(catch)
    declines = {}
    shard_kernels = {"K14": 0, "K15": 0, "K16": 0, "K17": 0}
    try:
        MA = M * conv(h)
        for name, build in (("tau != sigma", lambda: tv_pds(conv(h), yt, tau=0.5, sigma=0.25)),
                            ("combined mode", lambda: tv_pds(MA, MA(yt)))):
            pds = build()
            catch.messages.clear()

            def decline_and_step(pds=pds):
                s = pds.with_shardings(x=rows)
                return s, s.run_fixed(2)

            (s, st), counts = count_launches(counters, decline_and_step)
            ok = s._fused is None and s.state_shardings is not None and len(catch.messages) == 1
            bad = {k: counts[k] for k in shard_kernels if counts[k]}
            log(f"decline ({name}): generic chain {ok}, warning {catch.messages}, launches {counts}")
            if not ok or bad:
                raise AssertionError(f"decline ({name}): routed, no warning, or shard kernels launched {bad}")
            declines[name] = {"warning": catch.messages[0], "launches": counts}
    finally:
        flog.removeHandler(catch)
    real_init = DistributedTVDeconv2D.__init__

    def broken(self, *a, **k):
        raise RuntimeError("kernel build failed (patched in chip_smoke)")

    solvers.DistributedTVDeconv2D.__init__ = broken
    try:
        tv_pds(conv(h), yt).with_shardings(x=rows)
        raise AssertionError("with_shardings swallowed a constructor's RuntimeError")
    except RuntimeError as e:
        log(f"a constructor's RuntimeError propagates out of with_shardings: {e}")
        declines["RuntimeError propagates"] = True
    finally:
        solvers.DistributedTVDeconv2D.__init__ = real_init
    out["declines"] = declines
    section("declines")

    # (c) the twins
    twins = {}
    for psf, data, engine, kernel in ((h, yt, "mega2", "K11"), (h2, y2, "megar", "K4")):
        tv = TVDeconvolution(SHAPE, data, LAM, filt=psf, max_iter=3000)
        (tw, st), counts = count_launches(counters,
                                          lambda: (lambda t: (t, t.run_fixed(21)))(tv.with_shardings(x=rows)))
        ref = TVDeconvolution(SHAPE, data, LAM, filt=psf, stencil=engine, max_iter=3000).run_fixed(21)
        same = bool(torch.equal(st["x"], ref["x"]))
        log(f"TVDeconvolution.with_shardings: [{tv.stencil_mode}] -> [{tw.stencil_mode}], {st['it']} iterations in "
            f"run_fixed(21); launches {counts}; x bit for bit TVDeconvolution[{engine}]: {same}")
        expect_launches("TVDeconvolution.with_shardings", counts, {kernel: 21})
        if tw.stencil_mode != engine or st["it"] != 21 or not same:
            raise AssertionError(f"TVDeconvolution.with_shardings is not {engine} one iteration a step")
        twins[f"TVDeconvolution[{engine}]"] = {"engine": tw.stencil_mode, "launches": counts}
        if engine == "mega2":
            twin_solver = tw
        del st, ref
    prng = np.random.default_rng(6)
    xm = np.abs(prng.standard_normal(SHAPE_MCMC)).astype(np.float32)
    ym = torch.from_numpy(fftconvolve(xm, h, mode="same").astype(np.float32)).to(dev)
    sampler = PMYULA(SHAPE_MCMC, F=SquaredL2Loss(SHAPE_MCMC, data=ym) * Convolve2D(SHAPE_MCMC, h, device=dev),
                     G=LAM_L1 * L1Norm(SHAPE_MCMC), seed=3, nb_burnin_iterations=5, max_iter=2000)
    (ms, sst), counts = count_launches(
        counters, lambda: (lambda t: (t, t.run_fixed(N_MCMC_P15)))(sampler.with_shardings(x=rows)))
    fref = sampler.run_fixed(N_MCMC_P15)
    err = max(max_err(sst[k], fref[k])[0] / max(1.0, float(fref[k].abs().max())) for k in ("x", "mmse_raw"))
    log(f"PMYULA.with_shardings: [{sampler.engine}] -> [{ms.engine or 'generic chain'}], {N_MCMC_P15} samples; "
        f"launches {counts}; against the fused engine max rel err {err:.3e} (tol {TOL_PATH:g})")
    if counts["K9"] or ms.engine or err > TOL_PATH:
        raise AssertionError("PMYULA.with_shardings launched K9 or disagrees with the fused engine")
    twins["PMYULA"] = {"launches": counts, "rel_err": err}
    apgd = APGD(SHAPE, F=SquaredL2Loss(SHAPE, data=yt) * conv(h), G=LAM_L1 * L1Norm(SHAPE), max_iter=3000)
    (la, lst), counts = count_launches(counters, lambda: (lambda t: (t, t.run_fixed(N_P15)))(apgd.with_shardings(x=rows)))
    lref = apgd.run_fixed(N_P15)
    err = max_err(lst["x_temp"], lref["x_temp"])[0] / max(1.0, float(lref["x_temp"].abs().max()))
    log(f"LASSO APGD.with_shardings: fused {type(apgd._fused).__name__}[{apgd._fused.engine}] dropped "
        f"({la._fused is None}); launches {counts}; against the fused run max rel err {err:.3e} (tol {TOL_PATH:g})")
    if counts["K8"] or la._fused is not None or err > TOL_PATH:
        raise AssertionError("APGD.with_shardings launched K8 or disagrees with the fused run")
    twins["LASSO APGD"] = {"launches": counts, "rel_err": err}
    out["twins"] = twins
    del sampler, ms, sst, fref, la, lst, lref
    section("twins")

    # (d) ShardedDenseOperator at 16384^2
    n = N_DENSE_P15
    gen = torch.Generator(device=dev).manual_seed(SEED + 15)
    A = torch.randn((n, n), generator=gen, device=dev)
    v = torch.randn((n,), generator=gen, device=dev)
    w = torch.randn((n,), generator=gen, device=dev)
    with full_f32():
        want_v, want_w = A @ v, A.T @ w
    # the bound: one read of the matrix at the peak rate (a read-only stream beats the copy rate)
    dense = {"bound_ms": 1e3 * n * n * 4 / PEAK_BYTES_PER_S,
             "copy_rate_ms": 1e3 * n * n * 4 / HBM_MEASURED_BYTES_PER_S}
    ops = {
        "rows": ShardedDenseOperator(A, mesh=mesh, row_axis="sp"),
        "from_blocks": ShardedDenseOperator.from_blocks(list(A.chunk(SHARDS)), mesh=mesh),
        "2-D (2, 2)": ShardedDenseOperator(A, mesh=make_mesh(MESH2D, ("r", "c"), [dev] * SHARDS), row_axis="r",
                                           col_axis="c"),
    }
    for name, op in ops.items():
        ea = max_err(op.apply(v), want_v)[0] / float(want_v.abs().max())
        eh = max_err(op.adjoint(w), want_w)[0] / float(want_w.abs().max())
        rec = {"apply_rel_err": ea, "adjoint_rel_err": eh}
        if name != "from_blocks":
            rec["apply_ms"], rec["adjoint_ms"] = slope_ms(lambda: op.apply(v)), slope_ms(lambda: op.adjoint(w))
        dense[name] = rec
        log(f"ShardedDenseOperator {name} {n}^2 on {SHARDS} blocks: apply rel err {ea:.3e}, adjoint {eh:.3e} "
            f"(tol {TOL_OP_P15:g})" + (f"; slope-timed apply {rec['apply_ms']:.4f} ms, adjoint "
                                        f"{rec['adjoint_ms']:.4f} ms" if "apply_ms" in rec else ""))
        if max(ea, eh) > TOL_OP_P15:
            raise AssertionError(f"ShardedDenseOperator {name} disagrees with torch.matmul")
    with full_f32():
        dense["matmul_ms"] = slope_ms(lambda: A @ v)
    log(f"torch.matmul of the whole matrix: {dense['matmul_ms']:.4f} ms; bound {dense['bound_ms']:.4f} ms "
        f"(one read of {n * n * 4 / 2**30:.3g} GiB at {PEAK_BYTES_PER_S / 1e12:.2f} TB/s; "
        f"{dense['copy_rate_ms']:.4f} ms at the measured copy rate {HBM_MEASURED_BYTES_PER_S / 1e9:.1f} GB/s)")
    out["dense"] = dense
    del A, ops
    torch.cuda.empty_cache()
    section("dense")

    # (e) ShardedBlockDiagonalOperator of band Convolve2Ds (K1)
    blocks = stack_operators([Convolve2D(SHAPE_BLOCK_P15, gaussian_kernel(KSIZE, 1.0 + 0.25 * i), device=dev)
                              for i in range(N_BLOCKS_P15)])
    B = ShardedBlockDiagonalOperator(blocks, n_blocks=N_BLOCKS_P15, mesh=make_mesh((SHARDS,), ("dp",), [dev] * SHARDS))
    xb = torch.randn((N_BLOCKS_P15,) + SHAPE_BLOCK_P15, generator=gen, device=dev)
    got, counts = count_launches(counters, lambda: B.apply(xb))
    want = torch.stack([op.apply(xb[i]) for i, op in enumerate(blocks)])
    same = bool(torch.equal(got, want))
    log(f"ShardedBlockDiagonalOperator of {N_BLOCKS_P15} band Convolve2D {SHAPE_BLOCK_P15[0]}^2 blocks on "
        f"{SHARDS} positions: one apply's launches {counts}; bit for bit the blocks one by one: {same}")
    expect_launches("ShardedBlockDiagonalOperator", counts, {"K1": N_BLOCKS_P15})
    if not same:
        raise AssertionError("ShardedBlockDiagonalOperator disagrees with its blocks")
    out["block_diagonal"] = {"launches": counts, "apply_ms": median_ms(lambda: B.apply(xb))}
    block_k1 = counts["K1"]
    section("block diagonal")

    # (f) the pencil FFT at 4096^2
    pen = PencilCircularConv2D(SHAPE, h, mesh=mesh)
    cc = CircularConvolve(SHAPE, h, device=dev)
    xp = torch.randn(SHAPE, generator=gen, device=dev)
    yp = torch.randn(SHAPE, generator=gen, device=dev)
    pencil = {}
    for name, a, b in (("apply", pen.apply(xp), cc.apply(xp)), ("adjoint", pen.adjoint(xp), cc.adjoint(xp)),
                       ("gram", pen.gram.apply(xp), cc.adjoint(cc.apply(xp))),
                       ("pinv", pen.pinv(xp, damp=1e-3), cc.pinv(xp, damp=1e-3))):
        pencil[f"{name}_rel_err"] = e = max_err(a, b)[0] / float(b.abs().max())
        if e > TOL_OP_P15:
            raise AssertionError(f"PencilCircularConv2D.{name} disagrees with CircularConvolve ({e:.3e})")
    lhs, rhs = float(torch.sum(pen.apply(xp) * yp)), float(torch.sum(xp * pen.adjoint(yp)))
    pencil["dot_test"] = abs(lhs - rhs) / (float(torch.linalg.vector_norm(pen.apply(xp)))
                                           * float(torch.linalg.vector_norm(yp)))
    if pencil["dot_test"] > TOL_ADJOINT:
        raise AssertionError("PencilCircularConv2D fails the dot test")
    pencil["apply_ms"], pencil["circular_apply_ms"] = median_ms(lambda: pen.apply(xp)), median_ms(lambda: cc.apply(xp))
    pencil["apply_host_ms"] = host_ms(lambda: pen.apply(xp), n=50)
    pencil["circular_apply_host_ms"] = host_ms(lambda: cc.apply(xp), n=50)
    x_circ = blocks_image(rng, SHAPE)
    yc = cc.apply(torch.from_numpy(x_circ).to(dev))

    def circ_apgd(op):
        return APGD(SHAPE, F=SquaredL2Loss(SHAPE, data=yc) * op, x0=torch.zeros(SHAPE, device=dev),
                    G=NonNegativeOrthant(SHAPE), max_iter=3000)

    xs = circ_apgd(pen).with_shardings(x=rows).run_fixed(N_PENCIL_APGD)["x"]
    xr = circ_apgd(cc).run_fixed(N_PENCIL_APGD)["x"]
    pencil["apgd_rel_err"] = e = max_err(xs, xr)[0] / max(1.0, float(xr.abs().max()))
    log(f"PencilCircularConv2D {SHAPE[0]}^2 on {SHARDS} shards against CircularConvolve: "
        + ", ".join(f"{k} {v:.3e}" for k, v in pencil.items() if k.endswith("err") or k == "dot_test")
        + f"; apply {pencil['apply_ms']:.4f} ms device, {pencil['apply_host_ms']:.4f} ms host (CircularConvolve "
        f"{pencil['circular_apply_ms']:.4f} ms, {pencil['circular_apply_host_ms']:.4f} ms host)")
    if e > TOL_PATH:
        raise AssertionError("APGD.with_shardings over the pencil operator disagrees with the unsharded APGD")
    out["pencil"] = pencil
    del pen, cc, xp, yp, xs, xr
    section("pencil")

    # (g) distributed_init of one process
    distributed_init()
    distributed_init(num_processes=1)
    init = bool(torch.distributed.is_available() and torch.distributed.is_initialized())
    log(f"distributed_init() of one process: torch.distributed.is_initialized() = {init} (no second rank on "
        "one card: no NCCL run)")
    if init:
        raise AssertionError("distributed_init of one process initialised torch.distributed")
    out["distributed_init_noop"] = True

    # (h) rates: routed and hand-built alternately
    rates = {}
    timed = functools.partial(time_solver, n_short=10, n_long=60, reps=2)
    for name, (s, hand) in routed.items():
        r1, h1, r2, h2_ = timed(s), timed(hand), timed(s), timed(hand)
        rec = {"routed_iters_per_s": [r1, r2], "hand_iters_per_s": [h1, h2_]}
        rec["routed_device_idle_share"] = idle_share(s, statistics.mean([r1, r2]))
        rates[name] = rec
        log(f"{name}: routed {r1:.1f}, {r2:.1f} iters/s, hand-built {h1:.1f}, {h2_:.1f} iters/s (alternately); "
            f"routed device idle share {rec['routed_device_idle_share']}")
    ips = timed(twin_solver)
    rates["TVDeconvolution.with_shardings (mega2)"] = {"iters_per_s": ips,
                                                       "device_idle_share": idle_share(twin_solver, ips)}
    log(f"TVDeconvolution.with_shardings [mega2] at {SHAPE[0]}^2: {ips:.1f} iters/s")
    out["rates"] = rates
    section("rates")
    out["block_k1"] = block_k1
    out["seconds"], out["section_s"] = time.perf_counter() - t_phase, sections
    log(f"phase 15: {out['seconds']:.1f} s; by section " + ", ".join(f"{k} {v:.1f}" for k, v in sections.items()))
    return out


# -- phase 16: the sharded solvers and operators across two processes on one card

P16_ITERS = 20  # iterations of each counted run
P16_ADMM_D = 128  # the cfg5-style cube's edge (cfg5_problem: bench.py sec_cfg5_admm3d's draws)
N_DENSE_P16 = 16384
TOL_OP_P16 = 1e-6  # an operator across processes against the one-process mesh, x max |out|
P16_TIMEOUT = 300  # seconds for the two workers, their start on the card included
# case: (solver, data, mesh shape, ranks of the two processes, the kernel it launches once a position)
P16_TV = {
    "megasp": ("dist", "gauss", (4,), (0, 0, 1, 1), "K14"),
    "megarsp": ("dist", "rank2", (4,), (0, 0, 1, 1), "K15"),
    "sweepsp": ("dist", "mask", (4,), (0, 0, 1, 1), "K16"),
    "megar2d rows": ("2d", "gauss", (2, 2), (0, 0, 1, 1), "K17"),
    "megar2d cols": ("2d", "gauss", (2, 2), (0, 1, 0, 1), "K17"),
}


def _p16_mesh(dev, shape, ranks, names=None):
    """Four positions on ``dev``: within this process (``ranks`` None) or
    over two processes."""
    from pycsou_tpu_torch.parallel import Mesh

    names = names or (("sp",) if len(shape) == 1 else ("sp0", "sp1"))
    return Mesh([dev] * 4, names, shape, ranks=ranks)


def _p16_data(dev):
    """The TV problems at SHAPE, made on the card alike in every process:
    the piecewise-constant image blurred by K1 (Gaussian and rank-2 PSFs)
    or kept by the keep mask (inpainting), plus 0.01 noise."""
    from pycsou_tpu_torch.ops import Convolve2D

    rng = np.random.default_rng(SEED + 16)
    x = torch.from_numpy(blocks_image(rng, SHAPE)).to(dev)
    noise = torch.from_numpy((0.01 * rng.standard_normal(SHAPE)).astype(np.float32)).to(dev)
    m = torch.from_numpy(keep_mask(SHAPE).astype(np.float32)).to(dev)
    data = {psf: (h, Convolve2D(SHAPE, h, device=dev)(x) + noise, None)
            for psf, h in (("gauss", gaussian_kernel()), ("rank2", rank2_kernel()))}
    data["mask"] = (None, m * (x + noise), m)
    return data


def _p16_tv(case, dev, data, ranks):
    from pycsou_tpu_torch.parallel import DistributedTVDeconv2D, Spatial2DTVDeconv2D

    kind, psf, shape, _, _ = P16_TV[case]
    h, y, m = data[psf]
    mesh = _p16_mesh(dev, shape, ranks)
    if kind == "dist":
        return DistributedTVDeconv2D(SHAPE, h, y, LAM, mesh=mesh, mask=m, max_iter=3000)
    return Spatial2DTVDeconv2D(SHAPE, h, y, LAM, mesh=mesh, max_iter=3000)


def _p16_admm(dev, ranks):
    """cfg5's consensus ADMM (4 scenarios, Fourier x-updates, nonnegative z)
    at P16_ADMM_D^3, one scenario a position."""
    from pycsou_tpu_torch.func import NonNegativeOrthant
    from pycsou_tpu_torch.opt import ConsensusADMM

    d = P16_ADMM_D
    h_hats, data = cfg5_problem(d, dev)
    return ConsensusADMM((d,) * 3, h_hats, data, g=NonNegativeOrthant((d,) * 3), rho=1.0,
                         mesh=_p16_mesh(dev, (4,), ranks, ("dp",)), max_iter=3000)


def _p16_operators(dev, ranks):
    """``ShardedDenseOperator.from_blocks`` at N_DENSE_P16^2 (each row block
    drawn on the card from its position's seed, only this process's) and
    ``PencilCircularConv2D`` at SHAPE, with their inputs."""
    from pycsou_tpu_torch.parallel import PencilCircularConv2D, ShardedDenseOperator

    mesh = _p16_mesh(dev, (4,), ranks)
    n, rows = N_DENSE_P16, N_DENSE_P16 // 4

    def draw(shape, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        return torch.randn(shape, generator=g, device=dev)

    dense = ShardedDenseOperator.from_blocks([draw((rows, n), SEED + 100 + p) / math.sqrt(n)
                                              for p in mesh.local_positions], mesh=mesh)
    pencil = PencilCircularConv2D(SHAPE, gaussian_kernel(), mesh=mesh)
    return dense, pencil, draw((n,), SEED + 200), draw((n,), SEED + 201), draw(SHAPE, SEED + 202)


def _p16_outputs(dense, pencil, v, w, img):
    return {"dense apply": dense.apply(v), "dense adjoint": dense.adjoint(w), "pencil apply": pencil.apply(img),
            "pencil adjoint": pencil.adjoint(img)}


def _sha(t):
    import hashlib

    return hashlib.sha256(t.detach().contiguous().cpu().numpy().tobytes()).hexdigest()


def _z_of(out):
    return out["z"] if "z" in out else torch.stack([out["z0"], out["z1"]])


def phase16_worker(coord, rank, out_dir, dev=None):
    """``--phase16-worker COORD RANK DIR``: one of phase 16's two processes
    on ``cuda:0``, joined over gloo (CUDA tensors through host buffers:
    NCCL refuses two ranks on one card).  Each case as the parent ran it
    on one process, its positions of the mesh here: the joined results'
    hashes, the launches of the counted run, iters/s, the idle share and
    the bytes sent to the other process an iteration; the operators'
    outputs against the parent's.  Its record is the last line."""
    from pathlib import Path

    from pycsou_tpu_torch.parallel import distributed_init
    from pycsou_tpu_torch.parallel.mesh import transfer

    dev = torch.device("cuda", 0) if dev is None else dev
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    counters = build_kernels()  # the parent's build, loaded
    distributed_init(coordinator_address=coord, num_processes=2, process_id=rank, backend="gloo")
    t0 = time.perf_counter()
    rep = {"rank": rank, "backend": torch.distributed.get_backend(), "tv": {}}
    data = _p16_data(dev)

    def counted(fn):
        sent = transfer.sent_bytes
        out, counts = count_launches(counters, fn)
        return out, {k: v for k, v in counts.items() if v}, transfer.sent_bytes - sent

    def rates(solver):
        ips = time_solver(solver, n_short=10, n_long=40, reps=1)
        busy = device_ms_per_iteration(solver, n=10)
        return ips, None if busy is None else 1.0 - busy * ips / 1e3

    for case, (_, _, _, ranks, _) in P16_TV.items():
        solver, built, _ = counted(lambda: _p16_tv(case, dev, data, ranks))
        st, counts, sent = counted(lambda: solver.run_fixed(P16_ITERS))
        out = solver.postprocess(st)
        ips, idle = rates(solver)
        rep["tv"][case] = {"x": _sha(out["x"]), "z": _sha(_z_of(out)), "built": built, "launches": counts,
                           "sent_bytes_per_iteration": sent / P16_ITERS, "iters_per_s": ips,
                           "device_idle_share": idle}
        del solver, st, out
    admm = _p16_admm(dev, (0, 0, 1, 1))
    st, counts, sent = counted(lambda: admm.run_fixed(P16_ITERS))
    out = admm.postprocess(st)
    ips, idle = rates(admm)
    rep["admm"] = {"z": _sha(out["z"]), "u": _sha(out["u"]), "launches": counts,
                   "sent_bytes_per_iteration": sent / P16_ITERS, "iters_per_s": ips, "device_idle_share": idle}
    del admm, st, out
    dense, pencil, v, w, img = _p16_operators(dev, (0, 0, 1, 1))
    ref = torch.load(Path(out_dir) / "refs.pt", map_location=dev)
    got = _p16_outputs(dense, pencil, v, w, img)
    rep["operators"] = {k: max_err(got[k], ref[k])[0] / max(1.0, float(ref[k].abs().max())) for k in ref}
    rep["operators_ms"] = {"dense apply": slope_ms(lambda: dense.apply(v)),
                           "pencil apply": slope_ms(lambda: pencil.apply(img))}
    rep["seconds"] = time.perf_counter() - t0
    torch.distributed.destroy_process_group()
    print(json.dumps(rep), flush=True)
    return 0


def _p16_worker_cmd(coord, rank, out_dir):
    from pathlib import Path

    return [sys.executable, str(Path(__file__).resolve()), "--phase16-worker", coord, str(rank), str(out_dir)]


def phase_multiprocess(dev, counters):
    """Phase 16: the sharded solvers and operators on a mesh that spans two
    processes on this card.  The parent runs each case on a one-process
    mesh of four positions of ``dev`` (the reference), then starts two
    worker processes (``--phase16-worker``), each driving two of the
    positions over gloo; each joined x and z must hash as the parent's (bit
    for bit), each shard kernel launch 2 a worker an iteration, the
    operators agree within TOL_OP_P16.  Returns the record."""
    import shutil
    import socket
    from pathlib import Path

    t0 = time.perf_counter()
    out_dir = Path(__file__).resolve().parent / "build" / "phase16"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    data = _p16_data(dev)
    ref = {"tv": {}}
    for case, (_, _, _, _, kernel) in P16_TV.items():
        solver = _p16_tv(case, dev, data, None)
        st, counts = count_launches(counters, lambda: solver.run_fixed(P16_ITERS))
        expect_launches(f"one-process {case}", counts, {kernel: 4 * P16_ITERS})
        out = solver.postprocess(st)
        ref["tv"][case] = {"x": _sha(out["x"]), "z": _sha(_z_of(out))}
        del solver, st, out
    admm = _p16_admm(dev, None)
    out = admm.postprocess(admm.run_fixed(P16_ITERS))
    ref["admm"] = {"z": _sha(out["z"]), "u": _sha(out["u"])}
    del admm, out
    ops = _p16_operators(dev, None)
    torch.save(_p16_outputs(*ops), out_dir / "refs.pt")
    del ops
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t0

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        coord = f"127.0.0.1:{sock.getsockname()[1]}"
    procs = [subprocess.Popen(_p16_worker_cmd(coord, r, out_dir), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=P16_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, o) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            print(o[-8000:], file=sys.stderr)
            raise AssertionError(f"phase 16: worker {r} exited {p.returncode}")
    reps = [json.loads(o.strip().splitlines()[-1]) for o in outs]
    for rep in reps:
        r = rep["rank"]
        if rep["backend"] != "gloo":
            raise AssertionError(f"phase 16: worker {r} joined over {rep['backend']}")
        for case, (_, _, _, _, kernel) in P16_TV.items():
            got = rep["tv"][case]
            for k in ("x", "z"):
                if got[k] != ref["tv"][case][k]:
                    raise AssertionError(f"phase 16: worker {r}'s joined {k} of {case} differs from the one-process "
                                         "mesh's")
            expect_launches(f"phase 16 worker {r} {case}", {k: got["launches"].get(k, 0) for k in KERNELS},
                            {kernel: 2 * P16_ITERS})
            log(f"phase 16 worker {r} {case}: x, z bit for bit the one-process mesh's; launches {got['launches']} "
                f"in {P16_ITERS} iterations (construction {got['built']}); {got['iters_per_s']:.1f} iters/s, "
                f"device idle share {got['device_idle_share']}, "
                f"{got['sent_bytes_per_iteration']:.0f} bytes sent an iteration")
        for k in ("z", "u"):
            if rep["admm"][k] != ref["admm"][k]:
                raise AssertionError(f"phase 16: worker {r}'s ADMM {k} differs from the one-process mesh's")
        expect_launches(f"phase 16 worker {r} ADMM", {k: rep["admm"]["launches"].get(k, 0) for k in KERNELS}, {})
        log(f"phase 16 worker {r} ConsensusADMM at {P16_ADMM_D}^3, 4 scenarios: z, u bit for bit; "
            f"{rep['admm']['iters_per_s']:.1f} iters/s, idle {rep['admm']['device_idle_share']}, "
            f"{rep['admm']['sent_bytes_per_iteration']:.0f} bytes sent an iteration")
        for k, e in rep["operators"].items():
            if not e <= TOL_OP_P16:
                raise AssertionError(f"phase 16: worker {r}'s {k} differs by {e:.3e} (x max |out|)")
        log(f"phase 16 worker {r} operators against the one-process mesh (x max |out|): {rep['operators']}; "
            f"ms {rep['operators_ms']}; worker {rep['seconds']:.1f} s")
    return {"iters": P16_ITERS, "reference_s": ref_s, "seconds": time.perf_counter() - t0, "workers": reps}


# -- phase 17: the examples and the entry points --------------------------------------

P17_EXAMPLES = ("deconv_tv_2048", "motion_deblur_rank2", "inpainting_tv", "tv_denoise2d", "tutorial",
                "lasso_deconv1d", "stacked_sparse_lowfreq", "consensus_admm_3d", "bayes_uncertainty_mcmc",
                "rbf_interpolation")
# the fused examples: the engine each must run and the kernels it launches,
# those and no other (its engine's kernel, K1 for y = A x and A^H y)
P17_FUSED = {"deconv_tv_2048": ("mega3", {"K10", "K1"}), "motion_deblur_rank2": ("megar", {"K4", "K1"}),
             "inpainting_tv": ("sweepm2", {"K6"})}
# depth cut: the bayes twin at the reference's size (128 unknowns) but 1,000
# samples after 100 of burn-in, where the reference draws 20,000 after 2,000:
# its generic chain takes 18-24 ms a sample on the card (365 s for 20,000;
# PERF.md §6), host-bound on its many small launches
P17_ARGS = {"bayes_uncertainty_mcmc": dict(n_samples=1000, nb_burnin_iterations=100)}
P17_DRYRUN_N = 4  # dryrun_multichip's positions, each the card
P17_DRYRUN_PATHS = ("1:", "2:", "1b:", "1c:", "2b:", "2c2:", "2c3:", "2d:", "2e:", "3:", "3b:", "3c:")
TOL_ENTRY = 1e-6  # entry()'s step against TVDeconvolution's on the same state, x max(1, max |x|)


def load_example(name):
    """``examples/torch/<name>.py`` of this checkout as a module."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent / "examples" / "torch" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"example_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def example_figure(key, out):
    """The example's quality figure beside its observation's; raises
    unless the figure beats the observation."""
    if "psnr" in out:
        ok, fig = out["psnr"] > out["psnr_observed"], f"PSNR {out['psnr_observed']:.2f} -> {out['psnr']:.2f} dB"
    else:
        ok, fig = out["err"] < out["err_observed"], f"rel err {out['err_observed']:.4f} -> {out['err']:.4f}"
    if not ok:
        raise AssertionError(f"phase 17 {key}: the figure does not beat the observation ({fig})")
    return fig


def example_launches(name, out, launched):
    """A fused example runs its engine and launches exactly its kernels."""
    if name not in P17_FUSED:
        return
    engine, kernels = P17_FUSED[name]
    engines = set(out["engine"].values()) if isinstance(out["engine"], dict) else {out["engine"]}
    if engines != {engine}:
        raise AssertionError(f"phase 17 {name}: ran {sorted(engines)}, not {engine}")
    if set(launched) != kernels:
        raise AssertionError(f"phase 17 {name}: launched {launched}, expected exactly {sorted(kernels)}")


def _jsonable(v):
    if isinstance(v, dict):
        return {str(k): _jsonable(e) for k, e in v.items()}
    if isinstance(v, (np.floating, np.integer)):
        return v.item()
    return v


def phase_examples(dev, counters, smi):
    """Phase 17: every ``examples/torch`` twin's ``main()`` (and
    ``rbf_interpolation.main_large``) at the reference's size on the card
    (``P17_ARGS`` cuts the bayes twin's depth), each counted on its own: its figure must beat its observation, and the
    fused examples launch exactly their engine's kernels (``P17_FUSED``);
    then ``entry()``'s step (K10 once) against ``TVDeconvolution``'s step
    on the same state, and ``dryrun_multichip(P17_DRYRUN_N)`` on positions of
    the card, which must run every path (``P17_DRYRUN_PATHS``)."""
    from pycsou_tpu_torch.entry import NO_SPMD, dryrun_multichip, entry
    from pycsou_tpu_torch.opt import TVDeconvolution

    t_phase = time.perf_counter()
    rec = {"runs": {}}
    for name in P17_EXAMPLES:
        mod = load_example(name)
        main = functools.partial(mod.main, **P17_ARGS.get(name, {}))
        runs = [("main", main)] + ([("main_large", mod.main_large)] if hasattr(mod, "main_large") else [])
        for fn_name, fn in runs:
            key = name if fn_name == "main" else f"{name}.{fn_name}"
            t0 = time.perf_counter()
            out, counts = count_launches(counters, fn)
            secs = time.perf_counter() - t0
            launched = {k: v for k, v in counts.items() if v}
            fig = example_figure(key, out)
            example_launches(name, out, launched)
            log(f"phase 17 {key}: {secs:.2f} s, {fig}, engine {out['engine']}, launches {launched} ({smi})")
            rec["runs"][key] = {"seconds": secs, "figure": fig, "launches": launched, **_jsonable(out)}

    # entry(): one fused PDS iteration of the flagship problem
    (fn, (solver, state)), built = count_launches(counters, entry)
    fused = solver._fused
    tv = TVDeconvolution(tuple(fused.y.shape), fused.y, fused.lam, filt=fused.filt, nonneg=fused.nonneg,
                         tau=fused.tau, sigma=fused.sigma, rho=fused.rho, isotropic=fused.iso)
    if tv.stencil_mode != fused.stencil_mode:
        raise AssertionError(f"phase 17 entry: TVDeconvolution took {tv.stencil_mode}, entry {fused.stencil_mode}")
    copy = {k: v.clone() if isinstance(v, torch.Tensor) else v for k, v in state.items()}
    want = tv.step(copy)
    got, counts = count_launches(counters, lambda: fn(solver, state))
    launched = {k: v for k, v in counts.items() if v}
    if launched != {ENGINE_KERNEL[fused.stencil_mode]: 1}:
        raise AssertionError(f"phase 17 entry: the step launched {launched}")
    errs = {k: max_err(got[k], want[k])[0] for k in ("x", "z0", "z1")}
    scale = max(1.0, float(want["x"].abs().max()))
    if any(e > TOL_ENTRY * scale for e in errs.values()):
        raise AssertionError(f"phase 17 entry: the step differs from TVDeconvolution's by {errs}")
    log(f"phase 17 entry(): PDS -> TVDeconvolution[{fused.stencil_mode}], construction launches "
        f"{ {k: v for k, v in built.items() if v} }, the step {launched}; against TVDeconvolution's step "
        f"max |d| {errs} (tol {TOL_ENTRY:g} x {scale:.3f})")
    rec["entry"] = {"engine": fused.stencil_mode, "launches": launched, "max_abs_err": errs}

    # dryrun_multichip on P17_DRYRUN_N positions of the card
    t0 = time.perf_counter()
    paths, counts = count_launches(counters, lambda: dryrun_multichip(P17_DRYRUN_N))
    secs = time.perf_counter() - t0
    got_paths = tuple(p.split(" ")[0] for p in paths)
    if got_paths != P17_DRYRUN_PATHS:
        raise AssertionError(f"phase 17 dryrun_multichip({P17_DRYRUN_N}) ran {got_paths}, expected "
                             f"{P17_DRYRUN_PATHS}")
    launched = {k: v for k, v in counts.items() if v}
    for k in ("K14", "K15", "K16", "K17"):  # paths 1b, 1c, 2c3, 3c
        if not launched.get(k):
            raise AssertionError(f"phase 17 dryrun_multichip: {k} never launched ({launched})")
    log(f"phase 17 dryrun_multichip({P17_DRYRUN_N}) on {P17_DRYRUN_N} positions of {dev}: {len(paths)} paths in "
        f"{secs:.2f} s, launches {launched}; {NO_SPMD}")
    rec["dryrun"] = {"paths": list(paths), "seconds": secs, "launches": launched}
    rec["seconds"] = time.perf_counter() - t_phase
    return rec


def phase17_alone():
    """``--phase 17``: build the kernels and run phase 17 only; its record
    is the last line."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(smi)
    out = phase_examples(torch.device("cuda", 0), build_kernels(), smi)
    print(json.dumps({"examples": out, "card": smi}), flush=True)
    return 0


def phase16_alone():
    """``--phase 16``: build the kernels and run phase 16 only; its record
    is the last line."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(smi)
    out = phase_multiprocess(torch.device("cuda", 0), build_kernels())
    print(json.dumps({"multiprocess": out, "card": smi}), flush=True)
    return 0


def device_ms_per_iteration(solver, n=20):
    """Device time an iteration in a ``torch.profiler`` trace of ``n``
    iterations: the summed durations of the CUDA events (kernels, copies,
    fills); None when the trace holds none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    state = solver.run_fixed(2)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        solver.run_fixed(n, state=state)
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events() if e.device_type == DeviceType.CUDA)
    return us / 1e3 / n if us > 0 else None


def time_solver(solver, n_short=20, n_long=100, reps=3):
    """Slope-timed iterations/s (bench.py _time_solver): the difference of
    a long and a short run cancels the constant per-run cost."""
    state = solver.run_fixed(n_short)
    torch.cuda.synchronize()
    slopes = []
    for _ in range(reps):
        t0 = time.perf_counter()
        state = solver.run_fixed(n_short, state=state)
        torch.cuda.synchronize()
        ts = time.perf_counter() - t0
        t0 = time.perf_counter()
        state = solver.run_fixed(n_long, state=state)
        torch.cuda.synchronize()
        tl = time.perf_counter() - t0
        slopes.append((tl - ts) / (n_long - n_short))
    return 1.0 / statistics.median(slopes)


def build_kernels():
    """Build (or load) the CUDA kernels; the launch counters in KERNELS
    order."""
    from pycsou_tpu_torch.kernels import _build, conv2d, fista, langevin, sepgram, tv, tvr

    t0 = time.perf_counter()
    _build.library()
    log(f"kernels built/loaded from {_build.build_dir()} in {time.perf_counter() - t0:.2f} s")
    return [conv2d.sepconv2d, conv2d.sepgram2d, tv.tv_pds_sweep_step_stats, tvr.tv_pds_megar_step,
            tv.tv_pds_sweepm_step_stats, tv.tv_pds_sweepm2_step, tvr.tv_pds_megarm_step,
            fista.lasso_fista_step, langevin.pmyula_mega_step, tv.tv_pds_mega3_step,
            tv.tv_pds_mega2_step, tv.tv_pds_mega_step, tv.tv_pds_stencil_step,
            tv.tv_pds_mega2_shard_step, tvr.tv_pds_megar_shard_step, tv.tv_pds_sweep_shard_step,
            tvr.tv_pds_megar_shard2d_step, sepgram.sepgram_apply]


def phase14_alone():
    """``--phase 14``: build the kernels and run phase 14 only; its record
    is the last line."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(smi)
    res = {"K16": {}}
    out = phase_solver_io_chain(torch.device("cuda", 0), build_kernels(), res)
    print(json.dumps({"solver_io_chain": out, "K16": res["K16"], "card": smi}), flush=True)
    return 0


def phase15_alone():
    """``--phase 15``: build the kernels and run phase 15 only; its record
    is the last line."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(smi)
    out = phase_sharded_entry(torch.device("cuda", 0), build_kernels())
    print(json.dumps({"sharded_entry": out, "card": smi}), flush=True)
    return 0


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    dev = torch.device("cuda", 0)

    counters = build_kernels()

    rng = np.random.default_rng(SEED)
    log(f"-- kernels against their plain versions at {SHAPE[0]} x {SHAPE[1]}")
    res, copy_ms = phase_kernels(dev, rng)
    log(f"-- shard kernels on {SHARDS} row shards of {SHAPE[0]} x {SHAPE[1]}")
    phase_shard_kernels(dev, rng, res)
    log(f"-- block kernel on 2-D meshes of {SHAPE[0]} x {SHAPE[1]}, and sepgram_apply")
    k18_run = phase_block_kernels(dev, rng, res)
    _, runs_k18 = count_launches(counters, k18_run)
    log(f"sepgram_apply called directly on both PSFs; launches {runs_k18}")
    expect_launches("sepgram_apply", runs_k18, {"K18": 2})
    log("-- main path and the conv-mode engines")
    pds, runs, tv_solvers = phase_main_path(dev, rng, counters)
    log("-- masked paths")
    masked_runs, solvers = phase_masked_paths(dev, rng, counters)
    runs.update(masked_runs)
    log("-- LASSO path")
    apgd, runs["LASSO"] = phase_lasso_path(dev, rng, counters)
    log(f"-- other PSFs at {SHAPE[0]} x {SHAPE[1]}: rank 6 ('bandg'), full rank (the FFT Gram)")
    other_runs, other, gram_apply = phase_other_psfs(dev, rng, counters, res)
    runs.update(other_runs)
    log("-- PMYULA path")
    sampler, runs["PMYULA"] = phase_pmyula_path(dev, counters)
    log(f"-- sharded paths: DistributedTVDeconv2D on {SHARDS} row shards on one card")
    sharded_runs, sharded = phase_sharded_paths(dev, rng, counters)
    runs.update(sharded_runs)
    log(f"-- 2-D mesh path: Spatial2DTVDeconv2D on a {MESH2D} mesh on one card")
    mesh_runs, meshed = phase_spatial2d_paths(dev, rng, counters)
    runs.update(mesh_runs)
    runs["sepgram_apply"] = runs_k18
    log("-- stacked operators and spectral estimates: cfg4, the PDS with an unknown ||K||, the new operators")
    spectral, cfg4_solvers = phase_spectral(dev, counters)
    log("-- 1-D, N-D and circular convolutions, consensus ADMM: cfg1, cfg5, the CG backend")
    print(json.dumps({"conv_admm": phase_conv_admm(dev, counters), "card": smi}), flush=True)
    log("-- proximal calculus and sampling: Poisson-TV, L1 and group LASSO at 4096^2, the proxes, RBF fitting")
    print(json.dumps({"prox_sampling": phase_prox_sampling(dev, counters), "card": smi}), flush=True)
    log("-- checkpoint, objective, iterates, profiling on the main path; the sharded chain (phase 14)")
    print(json.dumps({"solver_io_chain": phase_solver_io_chain(dev, counters, res), "card": smi}), flush=True)
    log("-- the sharded entry points: with_shardings, the sharded dense and block operators, the pencil FFT "
        "(phase 15)")
    p15 = phase_sharded_entry(dev, counters)
    print(json.dumps({"sharded_entry": p15, "card": smi}), flush=True)
    for k, rec in p15["routed"].items():
        res[k]["routed_launches"], res[k]["routed_run"] = rec["launches"], rec["run"]
    res["K11"]["with_shardings_launches"] = p15["twins"]["TVDeconvolution[mega2]"]["launches"]["K11"]
    res["K4"]["with_shardings_launches"] = p15["twins"]["TVDeconvolution[megar]"]["launches"]["K4"]
    res["K1"]["block_diagonal_launches"] = p15["block_k1"]
    log("-- the sharded solvers and operators across two processes on the card (phase 16)")
    p16 = phase_multiprocess(dev, counters)
    print(json.dumps({"multiprocess": p16, "card": smi}), flush=True)
    for case, (_, _, _, _, k) in P16_TV.items():
        res[k].setdefault("multiprocess_launches", {})[case] = [w["tv"][case]["launches"].get(k, 0)
                                                                for w in p16["workers"]]
    res["K1"]["multiprocess_launches"] = {case: [w["tv"][case]["built"].get("K1", 0) for w in p16["workers"]]
                                          for case in P16_TV}
    log("-- the examples, entry() and dryrun_multichip on the card (phase 17)")
    print(json.dumps({"examples": phase_examples(dev, counters, smi), "card": smi}), flush=True)

    log(f"-- throughput ({smi})")
    solvers.update({"main path": pds, "LASSO": apgd})
    ips = {}
    for name in ("main path", "inpainting", "blurred super-resolution", "denoising", "LASSO"):
        ips[name] = v = time_solver(solvers[name])
        fused = solvers[name]._fused
        engine = getattr(fused, "stencil_mode", None) or fused.engine
        log(f"{name} {type(solvers[name]).__name__}[{engine}] slope-timed: {v:.1f} iters/s "
            f"({1e3 / v:.4f} ms/iteration)")
    for name in ("main path (rank-2 PSF)", "fuse=False"):
        ips[name] = v = time_solver(tv_solvers[name])
        log(f"{name} PDS[{getattr(tv_solvers[name]._fused, 'stencil_mode', 'generic chain')}] at {SHAPE[0]}^2 "
            f"slope-timed: {v:.1f} iters/s ({1e3 / v:.4f} ms/iteration)")
    for e in ("megar", "mega3", "mega2", "mega", "element"):
        ips[f"TVDeconvolution[{e}]"] = v = time_solver(tv_solvers[e])
        log(f"TVDeconvolution[{e}] at {SHAPE[0]}^2 slope-timed: {v:.1f} iters/s ({1e3 / v:.4f} ms/iteration)")
    for name, solver in sharded.items():
        ips[name] = v = time_solver(solver)
        log(f"{name} DistributedTVDeconv2D[{solver._sp_engine}] at {SHAPE[0]}^2 on {SHARDS} shards slope-timed: "
            f"{v:.1f} iters/s ({1e3 / v:.4f} ms/iteration)")
    for name, solver in meshed.items():
        ips[name] = v = time_solver(solver)
        log(f"{name} Spatial2DTVDeconv2D at {SHAPE[0]}^2 on a {MESH2D} mesh slope-timed: {v:.1f} iters/s "
            f"({1e3 / v:.4f} ms/iteration)")
    for name, solver in other.items():
        if name.endswith("TVDeconvolution"):  # the PDS route's engine, timed there
            continue
        ips[name] = v = time_solver(solver)
        tv = getattr(solver, "_fused", None) or solver
        engine = getattr(tv, "stencil_mode", None) or tv.engine
        log(f"{name} {type(solver).__name__}[{engine}, {type(tv.gram).__name__}] at {SHAPE[0]}^2 slope-timed: "
            f"{v:.1f} iters/s ({1e3 / v:.4f} ms/iteration)")
    sps = time_solver(sampler)
    log(f"PMYULA[{sampler.engine}] at {SHAPE_MCMC[0]}^2 slope-timed: {sps:.1f} samples/s "
        f"({1e3 / sps:.4f} ms/sample)")
    tol_solver = pds.replace(tol=1e-6, min_iter=50)
    tol_solver.run_fixed(5)  # warm
    torch.cuda.synchronize()
    info = tol_solver.solve()
    log(f"main path solve() to 1e-6: {info.elapsed:.3f} s, converged={info.converged} at iteration "
        f"{info.converged_at} ({info.n_iter} run)")
    if not info.converged or not math.isfinite(info.elapsed):
        raise AssertionError("solve() did not reach 1e-6")
    log(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    # last: a profiler trace can leave tracing on that slows later launches
    busy = device_ms_per_iteration(sharded["sharded megasp"])
    idle = None if busy is None else 1.0 - busy * ips["sharded megasp"] / 1e3
    log(f"sharded megasp: device time {busy} ms an iteration in a torch.profiler trace, "
        f"device idle share {idle} (not measured when None)")
    name2d = "2-D mesh megar2d (gauss)"
    busy2d = device_ms_per_iteration(meshed[name2d])
    idle2d = None if busy2d is None else 1.0 - busy2d * ips[name2d] / 1e3
    log(f"{name2d}: device time {busy2d} ms an iteration in a torch.profiler trace, "
        f"device idle share {idle2d} (not measured when None)")
    idle_m = {}
    for name in ("inpainting", "denoising"):
        busy_m = device_ms_per_iteration(solvers[name])
        idle_m[name] = None if busy_m is None else 1.0 - busy_m * ips[name] / 1e3
        log(f"{name} [sweepm2]: {ips[name]:.1f} iters/s, device time {busy_m} ms an iteration in a "
            f"torch.profiler trace, device idle share {idle_m[name]} (not measured when None)")
    idle_o = {}
    for name in ("rank 6 PDS", f"full rank {FULLRANK_FFT_K}x{FULLRANK_FFT_K} PDS", f"full rank {KSIZE}x{KSIZE} PDS",
                 f"full-rank LASSO ({FULLRANK_FFT_K}x{FULLRANK_FFT_K})"):
        busy_o = device_ms_per_iteration(other[name])
        idle_o[name] = None if busy_o is None else 1.0 - busy_o * ips[name] / 1e3
        log(f"{name}: {ips[name]:.1f} iters/s, device time {busy_o} ms an iteration in a torch.profiler trace, "
            f"device idle share {idle_o[name]} (not measured when None)")
    for name, solver in cfg4_solvers.items():
        m = int(name.split()[1].split("^")[0])
        rec = spectral["cfg4"][m]
        busy_c = device_ms_per_iteration(solver)
        rec["device_idle_share"] = None if busy_c is None else 1.0 - busy_c * rec["ips"] / 1e3
        log(f"{name} APGD: {rec['ips']:.1f} iters/s, device time {busy_c} ms an iteration in a torch.profiler "
            f"trace, device idle share {rec['device_idle_share']} (not measured when None)")
    idle_e = {}
    for e in ("megar", "mega2", "mega"):
        busy_e = device_ms_per_iteration(tv_solvers[e])
        idle_e[e] = None if busy_e is None else 1.0 - busy_e * ips[f"TVDeconvolution[{e}]"] / 1e3
        log(f"TVDeconvolution[{e}]: device time {busy_e} ms an iteration in a torch.profiler trace, "
            f"device idle share {idle_e[e]} (not measured when None)")

    def entry(k, run):
        name, source, replaces = KERNELS[k]
        r = res[k]
        out = {
            "name": f"{k} {name}", "route": "cuda", "source": source, "replaces": replaces,
            "launches": runs[run][k], "run": run,
            "max_abs_err": r["max_abs_err"], "max_rel_err": r["max_rel_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
            "library_ms": r.get("library_ms"),
        }
        for extra in ("rank2", "stream", "identity", "rank4"):
            if f"{extra}_ms" in r:
                out[f"{extra}_ms"], out[f"{extra}_plain_ms"] = r[f"{extra}_ms"], r[f"{extra}_plain_ms"]
        for extra, v in r.items():
            if extra.endswith("_bound"):  # a variant's bound: rank 2, rank 4, identity, Gram, Gaussian
                out[f"{extra}_ms"] = v[0]
        for extra in ("rank2_library_ms", "w_pass_ms", "one_shard_max_abs_err", "shard_ms", "shard_plain_ms",
                      "one_block_max_abs_err", "block_ms", "block_plain_ms", "k2_max_abs_err",
                      "rank2_k2_max_abs_err", "fft_gram_path_launches", "fft_gram_path_shard_ms",
                      "routed_launches", "routed_run", "with_shardings_launches", "block_diagonal_launches",
                      "multiprocess_launches"):
            if extra in r:
                out[extra] = r[extra]
        return out

    # "kernels": K1-K18, each with the launches of the run named in RUN_OF
    print(json.dumps({
        "kernels": [entry(k, run) for k, run in RUN_OF.items()],
        "copy_ms": copy_ms, "iters_per_s": ips, "pmyula_samples_per_s": sps,
        "time_to_1e6_s": info.elapsed, "sharded_megasp_device_idle_share": idle,
        "mesh2d_gauss_device_idle_share": idle2d, "megar_device_idle_share": idle_e["megar"],
        "mega2_device_idle_share": idle_e["mega2"], "mega_device_idle_share": idle_e["mega"],
        "inpainting_device_idle_share": idle_m["inpainting"], "denoising_device_idle_share": idle_m["denoising"],
        "rank6_iters_per_s": ips["rank 6 PDS"], "rank6_device_idle_share": idle_o["rank 6 PDS"],
        "fullrank_iters_per_s": ips[f"full rank {FULLRANK_FFT_K}x{FULLRANK_FFT_K} PDS"],
        "fullrank_device_idle_share": idle_o[f"full rank {FULLRANK_FFT_K}x{FULLRANK_FFT_K} PDS"],
        "other_psfs_device_idle_share": idle_o, "gram_apply_ms": gram_apply["device_ms"],
        "gram_apply_host_ms": gram_apply["host_ms"], "spectral": spectral,
        "card": smi,
    }), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


# -- A/B of the shared Gram's callers: python3 chip_smoke.py --gram-ab PARENT_ROOT


def gram_times(root, kernels_only=False):
    """``--gram-times ROOT [--kernels-only]``: with the package of the
    checkout at ROOT, the median CUDA-event ms of every caller of the shared
    Gram (K1, K2, K18, K4, K7, K8, K15 a middle 1024-row shard, K17 the
    median of the four 2048^2 blocks of the (2, 2) mesh at 4096^2; K9 at
    2048^2) on both PSFs, of K10 and K11 on the Gaussian and the identity
    PSF, of K12 on the Gaussian PSF (from ``w = ColGram(x)``, as the mega
    engine's ``_mega_colgram`` forms it), of K3 (a control), of the 1-D
    shard kernels K14 (Gaussian PSF) and K16
    (the keep mask's gradient) on a middle 1024-row shard, of K6 and K5 (a
    control) with the keep mask, and the host ms of a call of K14, K16 and
    K6 (``host_ms``); then, unless
    ``kernels_only``, the slope-timed rates of the paths they carry (the
    main path on mega3, mega2, mega and megar by name, small denoising at
    1024^2 on mega3, the sharded megasp, megarsp and sweepsp paths on SHARDS
    row shards, inpainting and ``PDS`` denoising on sweepm2), the main
    path's time to 1e-6 and the device-idle share of the (2, 2) path, of
    mega2, mega and megar, of the main path, of sharded megasp and sweepsp,
    and of inpainting and denoising; one JSON line."""
    sys.path.insert(0, str(root))
    from scipy.signal import fftconvolve

    from pycsou_tpu_torch.func import L1Norm, L21Norm, NonNegativeOrthant, SquaredL2Loss
    from pycsou_tpu_torch.kernels import _build
    from pycsou_tpu_torch.kernels.conv2d import SepFactors, sepconv2d, sepgram2d
    from pycsou_tpu_torch.kernels.fista import lasso_fista_step
    from pycsou_tpu_torch.kernels.langevin import pmyula_mega_step
    from pycsou_tpu_torch.kernels.sepgram import sepgram_apply
    from pycsou_tpu_torch.kernels.tv import (
        tv_pds_mega2_shard_step, tv_pds_mega2_step, tv_pds_mega3_step, tv_pds_mega_step,
        tv_pds_sweep_shard_step, tv_pds_sweep_step_stats, tv_pds_sweepm2_step, tv_pds_sweepm_step_stats,
    )
    from pycsou_tpu_torch.kernels.band import gram_band_cols
    from pycsou_tpu_torch.kernels.tvr import (
        HALO_COLS, tv_pds_megar_shard2d_step, tv_pds_megar_shard_step, tv_pds_megar_step,
    )
    from pycsou_tpu_torch.ops import Convolve2D, Gradient, Masking
    from pycsou_tpu_torch.ops.conv import lowrank_factors
    from pycsou_tpu_torch.opt import APGD, PDS, PMYULA, TVDeconvolution
    from pycsou_tpu_torch.parallel import (
        DistributedTVDeconv2D, Spatial2DTVDeconv2D, halo_extend, halo_extend_2d, halos, halos_2d, lane_extend,
        make_mesh,
    )

    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    _build.library()
    out = {"root": str(root), "build_s": time.perf_counter() - t0, "ms": {}, "iters_per_s": {}, "idle": {}}
    ms = out["ms"]
    rng = np.random.default_rng(SEED)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)  # noqa: E731
    x, atb = t(np.abs(rng.standard_normal(SHAPE))), t(rng.standard_normal(SHAPE))
    z0, z1 = t(0.01 * rng.standard_normal(SHAPE)), t(0.01 * rng.standard_normal(SHAPE))
    m = t(keep_mask())
    x2, atb2, m1 = (t(rng.standard_normal(SHAPE_MCMC)) for _ in range(3))
    m2 = t(np.abs(rng.standard_normal(SHAPE_MCMC)))
    kw = dict(tau=0.3, sigma=0.3, rho=0.9, lam=LAM, nonneg=True, iso=True)
    mom, si, wf = torch.tensor([0.3], device=dev), torch.tensor([3, 25], dtype=torch.int32, device=dev), \
        torch.tensor([1.0], device=dev)
    H, W = SHAPE
    R, C, hs = 32, HALO_COLS, H // SHARDS
    cores = [[a[i * hs : (i + 1) * hs] for i in range(SHARDS)] for a in (x, z0, z1)]
    shard_halos, shard_atb = halos(cores, R), halo_extend([atb[i * hs : (i + 1) * hs] for i in range(SHARDS)], R)
    n0, n1 = MESH2D
    hb, wb = H // n0, W // n1
    grid = lambda a: tuple(tuple(a[i * hb : (i + 1) * hb, j * wb : (j + 1) * wb].contiguous()  # noqa: E731
                                 for j in range(n1)) for i in range(n0))
    ext = [lane_extend(grid(a), C) for a in (x, z0, z1)]
    block_halos, block_atb = halos_2d(ext, R), halo_extend_2d(grid(atb), R, C)
    gram_g = Convolve2D(SHAPE, gaussian_kernel(), device=dev).gram
    for psf, h in (("gauss", gaussian_kernel()), ("rank2", rank2_kernel())):
        us, vs = lowrank_factors(h)
        f = SepFactors(us, vs, h.shape[0] // 2, h.shape[1] // 2, dev)
        a2 = f.adjoint(2.0)
        ut, vt = tuple(map(tuple, us.T)), tuple(map(tuple, vs.T))
        ms[f"K1 {psf}"] = median_ms(lambda: sepconv2d(x, f))
        ms[f"K2 {psf}"] = median_ms(lambda: sepgram2d(x, f, a2, atb))
        ms[f"K18 {psf}"] = median_ms(lambda: sepgram_apply(x, ut, vt))
        ms[f"K4 {psf}"] = median_ms(lambda: tv_pds_megar_step(x, z0, z1, atb, f, a2, **kw))
        ms[f"K7 {psf}"] = median_ms(lambda: tv_pds_megar_step(x, z0, z1, atb, f, a2, mask=m, **kw))
        ms[f"K8 {psf}"] = median_ms(lambda: lasso_fista_step(x, z0, atb, mom, f, a2, tau=0.5, lam=LAM_L1))
        ms[f"K9 {psf}"] = median_ms(lambda: pmyula_mega_step(x2, atb2, m1, m2, si, wf, f, a2, gamma=1 / 3, tau=1.0,
                                                             lam=LAM_L1, prox_mode="l1", noise_mode="prng"))
        i = SHARDS // 2
        ms[f"K15 {psf}"] = median_ms(lambda: tv_pds_megar_shard_step(
            *(c[i] for c in cores), shard_atb[i], shard_halos[i], f, a2, i * hs - R, H_global=H, **kw))
        ms[f"K17 {psf}"] = statistics.median(
            median_ms(lambda: tv_pds_megar_shard2d_step(ext[0][i][j], ext[1][i][j], ext[2][i][j], block_atb[i][j],
                                                        block_halos[i][j], f, a2, (i * hb - R, j * wb - C),
                                                        H_global=H, W_global=W, **kw))
            for i in range(n0) for j in range(n1))
    gauss = gaussian_kernel()
    for psf, h in (("gauss", gauss), ("identity", np.ones((1, 1), np.float32))):
        gram = Convolve2D(SHAPE, h, device=dev).gram
        ms[f"K10 {psf}"] = median_ms(lambda: tv_pds_mega3_step(x, z0, z1, atb, gram, **kw))
        ms[f"K11 {psf}"] = median_ms(lambda: tv_pds_mega2_step(x, z0, z1, atb, gram, **kw))
    zs = torch.stack([z0, z1])
    zs[0, -1] = 0.0
    zs[1, :, -1] = 0.0
    w = gram_band_cols(x, gram_g.band_plans()[1]).contiguous()  # the mega engine's _mega_colgram(x)
    ms["K12 gauss"] = median_ms(lambda: tv_pds_mega_step(x, zs, w, atb, gram_g, **kw))
    del zs, w
    ms["K3 (control)"] = median_ms(lambda: tv_pds_sweep_step_stats(x, z0, z1, atb, **kw))
    # the masked paths' kernels with the keep mask, as phase_kernels calls
    # them: K6 (two iterations) and K5 (one, a control)
    matb = m * atb
    ms["K6 keep mask"] = median_ms(lambda: tv_pds_sweepm2_step(x, z0, z1, m, matb, **kw))
    ms["K5 keep mask (control)"] = median_ms(lambda: tv_pds_sweepm_step_stats(x, z0, z1, m, matb, **kw))
    # the 1-D shard kernels on a middle 1024-row shard: K14 with the Gaussian
    # PSF (16 halo rows), K16 with the keep mask's gradient 2 (m x - atb)
    # (one halo row), as the megasp and sweepsp engines call them
    i = SHARDS // 2
    split = lambda a: [a[j * hs : (j + 1) * hs] for j in range(SHARDS)]  # noqa: E731
    h14, a14 = halos(cores, 16)[i], halo_extend(split(atb), 16)[i]
    ms["K14 gauss"] = median_ms(lambda: tv_pds_mega2_shard_step(*(c[i] for c in cores), a14, h14, gram_g, i * hs - 16,
                                                                H_global=H, **kw))
    g16 = 2.0 * (m * x - atb)
    c16 = [split(a)[i] for a in (x, g16, z0, z1)]
    h16 = halos([split(a) for a in (x, g16, z0, z1)], 1)[i]
    ms["K16 keep mask"] = median_ms(lambda: tv_pds_sweep_shard_step(*c16, h16, i * hs - 1, H_global=H, **kw))
    out["host_ms"] = {
        "K14 gauss": host_ms(lambda: tv_pds_mega2_shard_step(*(c[i] for c in cores), a14, h14, gram_g, i * hs - 16,
                                                             H_global=H, **kw)),
        "K16 keep mask": host_ms(lambda: tv_pds_sweep_shard_step(*c16, h16, i * hs - 1, H_global=H, **kw)),
        "K6 keep mask": host_ms(lambda: tv_pds_sweepm2_step(x, z0, z1, m, matb, **kw)),
    }
    del cores, shard_halos, shard_atb, ext, block_halos, block_atb, h14, a14, g16, c16, h16, matb
    if kernels_only:
        print(json.dumps(out), flush=True)
        return 0

    # the paths, each slope-timed (the same problems as main's)
    xb = blocks_image(rng)
    blur = lambda h: torch.from_numpy((fftconvolve(xb, h, mode="same")  # noqa: E731
                                       + 0.01 * rng.standard_normal(SHAPE)).astype(np.float32)).to(dev)
    yg, yr = blur(gauss), blur(rank2_kernel())
    ys = m * torch.from_numpy((xb + 0.01 * rng.standard_normal(SHAPE)).astype(np.float32)).to(dev)

    def pds(y, op, **k):
        return PDS(SHAPE, F=SquaredL2Loss(op.codim_shape, data=y) * op, G=NonNegativeOrthant(SHAPE),
                   H=LAM * L21Norm((2,) + SHAPE, axis=0), K=Gradient(SHAPE), max_iter=3000, **k)

    MA = Masking(SHAPE, keep_mask(), device=dev) * Convolve2D(SHAPE, gauss, device=dev)
    ym = MA(torch.from_numpy(xb).to(dev))
    mesh1 = make_mesh((SHARDS,), devices=[dev] * SHARDS)
    mesh2 = make_mesh(MESH2D, ("sp0", "sp1"), devices=[dev] * (n0 * n1))
    ymc = torch.from_numpy(fftconvolve(np.abs(rng.standard_normal(SHAPE_MCMC)), gauss, mode="same")
                           .astype(np.float32)).to(dev)
    small = (1024, 1024)
    yd = torch.from_numpy(blocks_image(rng, small) + 0.1 * rng.standard_normal(small).astype(np.float32)).to(dev)
    # the masked paths on K6 (phase_masked_paths' problems)
    Mk = Masking(SHAPE, keep_mask(), device=dev)
    y_in = Mk(torch.from_numpy(xb).to(dev)) + torch.from_numpy(
        (0.01 * rng.standard_normal(Mk.codim_shape)).astype(np.float32)).to(dev)
    y_dn = torch.from_numpy((xb + 0.1 * rng.standard_normal(SHAPE)).astype(np.float32)).to(dev)
    paths = {
        "main path (mega3)": lambda: pds(yg, Convolve2D(SHAPE, gauss, device=dev)),
        "mega2 (gauss)": lambda: TVDeconvolution(SHAPE, yg, LAM, filt=gauss, stencil="mega2", max_iter=3000),
        "mega (gauss)": lambda: TVDeconvolution(SHAPE, yg, LAM, filt=gauss, stencil="mega", max_iter=3000),
        "megar (gauss)": lambda: TVDeconvolution(SHAPE, yg, LAM, filt=gauss, stencil="megar", max_iter=3000),
        "small denoising (1024^2)": lambda: PDS(small, F=SquaredL2Loss(small, data=yd), G=NonNegativeOrthant(small),
                                                H=LAM * L21Norm((2,) + small, axis=0), K=Gradient(small),
                                                max_iter=3000),
        "main path (rank-2 PSF)": lambda: pds(yr, Convolve2D(SHAPE, rank2_kernel(), device=dev)),
        "PDS fuse=False (gauss)": lambda: pds(yg, Convolve2D(SHAPE, gauss, device=dev), fuse=False),
        "blurred super-resolution": lambda: pds(ym, MA),
        "LASSO": lambda: APGD(SHAPE, F=SquaredL2Loss(SHAPE, data=yg) * Convolve2D(SHAPE, gauss, device=dev),
                              G=LAM_L1 * L1Norm(SHAPE), max_iter=3000),
        "PMYULA": lambda: PMYULA(SHAPE_MCMC, F=SquaredL2Loss(SHAPE_MCMC, data=ymc)
                                 * Convolve2D(SHAPE_MCMC, gauss, device=dev), G=LAM_L1 * L1Norm(SHAPE_MCMC),
                                 seed=3, nb_burnin_iterations=20, max_iter=2000),
        "sharded megasp": lambda: DistributedTVDeconv2D(SHAPE, gauss, yg, LAM, mesh=mesh1, max_iter=3000),
        "sharded megarsp": lambda: DistributedTVDeconv2D(SHAPE, rank2_kernel(), yr, LAM, mesh=mesh1, max_iter=3000),
        "sharded sweepsp": lambda: DistributedTVDeconv2D(SHAPE, None, ys, LAM, mesh=mesh1, mask=m, max_iter=3000),
        "2-D mesh (gauss)": lambda: Spatial2DTVDeconv2D(SHAPE, gauss, yg, LAM, mesh=mesh2, max_iter=3000),
        "2-D mesh (rank2)": lambda: Spatial2DTVDeconv2D(SHAPE, rank2_kernel(), yr, LAM, mesh=mesh2, max_iter=3000),
        "inpainting": lambda: pds(y_in, Mk),
        "PDS denoising": lambda: PDS(SHAPE, F=SquaredL2Loss(SHAPE, data=y_dn), G=NonNegativeOrthant(SHAPE),
                                     H=LAM * L21Norm((2,) + SHAPE, axis=0), K=Gradient(SHAPE), max_iter=3000),
    }
    for name, build in paths.items():
        solver = build()
        out["iters_per_s"][name] = v = time_solver(solver)
        if name == "main path (mega3)":
            if solver._fused.stencil_mode != "mega3":
                raise AssertionError(f"the main path runs {solver._fused.stencil_mode}, not mega3")
            tol_solver = solver.replace(tol=1e-6, min_iter=50)
            tol_solver.run_fixed(5)  # warm
            torch.cuda.synchronize()
            info = tol_solver.solve()
            if not info.converged:
                raise AssertionError("the main path's solve() did not reach 1e-6")
            out["time_to_1e6_s"] = info.elapsed
        if name in ("main path (mega3)", "mega2 (gauss)", "mega (gauss)", "megar (gauss)", "2-D mesh (gauss)",
                    "sharded megasp", "sharded sweepsp", "inpainting", "PDS denoising"):
            busy = device_ms_per_iteration(solver)
            out["idle"][name] = None if busy is None else 1.0 - busy * v / 1e3
        del solver
    torch.cuda.synchronize()
    print(json.dumps(out), flush=True)
    return 0


def gram_ab(parent):
    """``--gram-ab PARENT_ROOT``: gram_times of the parent's checkout and of
    this one in turns, parent, change, change, parent, each in a process of
    its own on the same card; prints each metric's four values and the ratio
    of the change's mean to the parent's, then the whole record as one JSON
    line."""
    from pathlib import Path

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA card", file=sys.stderr)
        return 2
    here, parent = Path(__file__).resolve().parent, Path(parent).resolve()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(smi)
    runs = []
    for label, root in (("parent", parent), ("change", here), ("change", here), ("parent", parent)):
        p = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--gram-times", str(root)], cwd=root,
                           capture_output=True, text=True, timeout=900)
        if p.returncode != 0:
            print(p.stdout[-4000:], p.stderr[-8000:], file=sys.stderr)
            raise RuntimeError(f"--gram-times {root} exited {p.returncode}")
        runs.append((label, json.loads(p.stdout.strip().splitlines()[-1])))
        log(f"{label} {root}: built/loaded in {runs[-1][1]['build_s']:.2f} s")
    table = {}
    for _, r in runs:
        r["time_to_1e6"] = {"main path (mega3)": r.get("time_to_1e6_s")}
    for group in ("ms", "host_ms", "iters_per_s", "idle", "time_to_1e6"):
        for key in runs[0][1][group]:
            vals = [r[group][key] for _, r in runs]
            par, chg = [v for (lb, _), v in zip(runs, vals) if lb == "parent"], \
                [v for (lb, _), v in zip(runs, vals) if lb == "change"]
            ratio = None if None in vals else statistics.mean(chg) / statistics.mean(par)
            table[f"{group} {key}"] = {"parent": par, "change": chg, "change/parent": ratio}
            log(f"{group:<12} {key:<28} parent {par}  change {chg}  change/parent {ratio}")
    record = {"card": smi, "order": [lb for lb, _ in runs], "build_s": [r["build_s"] for _, r in runs],
              "table": table}
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--phase", "14"]:
        sys.exit(phase14_alone())
    if sys.argv[1:] == ["--phase", "15"]:
        sys.exit(phase15_alone())
    if sys.argv[1:] == ["--phase", "16"]:
        sys.exit(phase16_alone())
    if sys.argv[1:] == ["--phase", "17"]:
        sys.exit(phase17_alone())
    if len(sys.argv) == 5 and sys.argv[1] == "--phase16-worker":
        sys.exit(phase16_worker(sys.argv[2], int(sys.argv[3]), sys.argv[4]))
    if len(sys.argv) in (3, 4) and sys.argv[1] == "--gram-times":
        sys.exit(gram_times(sys.argv[2], kernels_only=sys.argv[3:] == ["--kernels-only"]))
    if len(sys.argv) == 3 and sys.argv[1] == "--gram-ab":
        sys.exit(gram_ab(sys.argv[2]))
    sys.exit(main())
