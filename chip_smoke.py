"""Smoke run of spartan_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths once through its user entry points, at the
sizes of the reference's benchmark configs 1-5 (config 2 also at its
published 32768^2), of PageRank at full width, of ALS at the shape of
MovieLens 20M and of heat and Jacobi-Poisson sweeps on a 16384^2 grid, the
last three also on meshes of 2, 4 and 8 logical shards of the card, and
raises on any failure:

  0. identify the card (nvidia-smi name and power limit, torch and CUDA);
  1. build the kernels (csrc/fused_reduce.cu, fused_reduce_rare1.cu,
     fused_reduce_rare.cu, spmv_ell.cu, spmv_csr.cu,
     spmm_csr.cu, stencil3x3.cu, stencil3x3_padded.cu, matmul.cu,
     spmv_chunked.cu) from source, one nvcc per file, all started together;
     the sharded kernels are these kernels over the shards' row bands (K3a
     sharded and K3d one launch over a table of bands, K5b and K6b a
     launch a band), K6b the halo-row instantiation in
     stencil3x3_padded.cu;
  2. K1 against its plain torch version on the card, over nine chains
     (power, floor division and remainder among them) and fourteen of the
     trig, hyperbolic, rounding and log/exp ops (each of the 31 new ones
     in one), four shapes, each also as the flattened x[1:] (a base off
     16-byte alignment), and two accumulators, bit-equal on repeat, with
     ptxas's report of each of its kernels, common and rare (0-byte stack
     frame, no spill); sin of 1e6 v and sin/cos/tan of values up to 1e30
     against a float64 evaluation on the card (an ulp an element); then
     each chain timed at 16384^2 float32 beside the plain version and
     torch.sum;
  3. the fused map+reduce (affine and kernel paths) and a 4096^2 dot,
     against float64 NumPy oracles;
  4. linear-regression training at n = 2^20, d = 64, float64, against a
     NumPy loop, and make_fori against fit;
  5. the SpMV kernels K3a (spmv_ell, x in each block's shared memory) and
     K3b (spmv_csr) against their plain versions on six matrices (the two
     PageRank graphs among them), with ptxas's report of each (0-byte stack
     frame, no spill) and the check's power on K3a (without lane 0's
     partial of the longest row, a result must fail it), then timed beside
     their plain versions and cuSPARSE (torch.sparse_csr_tensor @ x), with
     the calls queued ahead of the device so that the events read device
     time, and the host's issue time per call apart;
  6. PageRank through pagerank.fit_sparse(sparse.from_scipy(A)): a GAP
     "urand" graph (uniform random targets, 16 out-edges a node) at
     n = 2^22 (CSR kernel) and n = 32768 (ELL kernel), and the
     block-structured shape of the reference's benchmark config 5 (block
     route, no kernel), each against a float64 scipy power iteration (the
     2^22 graph's in a worker process, started with phase 22's oracles
     before the build);
  7. a ratings matrix of MovieLens 20M's shape (138,493 users, 26,744
     movies, 20,000,263 ratings, the heaviest user and the most-rated movie
     near the dataset's), drawn on the card from a seed and ingested through
     sparse.from_scipy(R, dtype=np.float32); the SpMM kernel K5a (spmm_csr)
     against its plain version on small odd shapes, k in {1, 3, 64, 130,
     512}, bfloat16/float16/float64 and non-contiguous B, on a skewed
     matrix whose rows split into the kernel's segments (0 to 70,000
     entries, k in {1, 3, 4, 31, 64, 130, 512}), and both ALS products at
     k = 64, with the check's power on the 70,000-entry row (without its
     partials after the first 32, or without one segment, the result must
     fail it), then those two products timed beside the plain version and
     cuSPARSE (torch.sparse_csr_tensor @ B), with their segment counts and
     gathered bytes;
  8. ALS through als.fit(R, k=64, iterations=5) on that matrix, against a
     float64 scipy ALS from the same initial factors, with the RMSE over the
     stored ratings, ms per iteration and a profile of one iteration;
  9. the 3x3 stencil kernels K4 (stencil3x3) and K6a (stencil3x3_padded)
     against their plain versions on six shapes, two coefficient sets,
     float32 (bit for bit), bfloat16 and float16, K6a with and without its
     add field over 1-3 steps, then timed at 16384^2 float32 beside their
     plain versions and cuDNN (F.conv2d, TF32 off);
 10. heat.simulate_padded and poisson.solve_jacobi, 200 sweeps each on a
     16384^2 float32 grid, against float64 iterations on the card; the
     expression path heat.simulate at 4096^2 float64 against
     simulate_numpy; convnet.forward and predict on MNIST's test-set shape
     against a float64 numpy forward;
 11. the matrix-product kernel K2 (matmul) against its plain version on
     seven shapes (the 16-bit kernel's full tile, ragged last tiles, K off
     its 64-deep stages, operands it pads), three dtypes, with the ReLU
     epilogue fused and without, and one epilogue outside the op table,
     with ptxas's report of the 16-bit kernel; then matmul.matmul at
     config 2's published 32768^2 float32 against torch.matmul (TF32 off)
     and at bench.py's 8192^2 bfloat16, each timed beside matmul_plain and
     cuBLAS;
 12. the unique-rows SpMV kernel K3c (spmv_chunked) against its plain
     version on eight edge cases in both its forms (x's windows in shared
     memory, and the CSR as it is) and three x dtypes (bit for bit on
     repeat), with the check's power on the full-size results (without one
     window's partial of the longest row, or one chunk's head, a result
     must fail it); timed on phase 5's urand 2^22 graph (unwindowed) and
     phase 7's ML-20M R.T (windowed; both held, not rebuilt) beside its
     plain version, the other form, K3b and cuSPARSE, each pack's form
     counted; make_spmv_windowed over a classic and a unique pack of each,
     by launch counts;
 13. k-means (config 4: n = 2^19, d = k = 64 float32, both centroid
     updates, make_fori and fit_fused) against a float64 NumPy Lloyd, and
     logistic_reg.fit_fused at n = 2^20, d = 64 float64 against a NumPy
     loop;
 14. on meshes of p = 2, 4 and 8 shards of the card: pagerank.fit_sparse
     on phase 6's two urand graphs (K3d at 2^22, K3a sharded at 32768)
     against phase 6's float64 ranks, als.fit on the ratings of phase 7
     (K5b) against phase 8's float64 factors, 200 heat sweeps at 16384^2
     through stencil3x3_padded_sharded (K6b) bit for bit against phase
     10's K6a field and 20 Jacobi sweeps with the add field against a
     float64 oracle; each sharded entry point bit for bit against its
     unsharded kernel (K5b also on phase 7's skewed matrix) and against
     its plain version at the unsharded kernel's bound; each timed at
     full shape beside the unsharded kernel, its plain version and
     cuSPARSE or cuDNN; K3a sharded and K3d one launch a call, their bands
     counted;
 15. the core expression surface at config 1's 16384^2 float32 through the
     entry points: (b ** 2).sum(), (b // 0.3).sum() and (b % 0.7).sum()
     each one K1 launch (no plain route), var, std with ddof, prod over a
     slice, all and any, sliced sums and means, a 4096-row gather, a
     2^22-element (rows, cols) gather, b[b > 2.5] on the device,
     b.at[rows, cols].add(1.0) with duplicates against np.add.at, nanmean
     with NaN planted, each against a float64 NumPy oracle, and how much
     of b[1:-1, 1:-1].sum() is the contiguous copy K1 reads;
 16. the builtins at config 1's 16384^2 float32 through the entry points:
     seven K1 sums of the new ufuncs (sin, tanh, floor, log1p, arctan2,
     hypot, sin of 1e6 b; no plain route) against NumPy's float32 values
     summed in float64, each timed beside its plain version and
     torch.sum(torch.<op>(x)); K2 with a fused tanh epilogue at 8192^2
     bfloat16 against a float64 product, timed beside cuBLAS + torch.tanh;
     eye, linspace(0, 1, 2^28), meshgrid, zeros_like, nonzero(b > 2.5),
     compress, choose, resize, unique/isin/bincount over 2^26 int32 keys
     and map_with_location, each against NumPy; the phase's host seconds
     outside its items printed by kind;
 17. the linear-algebra, statistics, polynomial, histogram and shape
     builtins at config 1's 16384^2 float32 through the entry points:
     sp.norm(b), sp.norm(b, 1) and sp.norm(b, 3) each one K1 launch (no
     plain route), timed beside the plain version and
     torch.linalg.vector_norm(x, ord, dtype=float64); einsum of three
     4096^2 matrices (pairwise TensorDotExprs), tensordot, vdot, kron of
     two 128^2 blocks, cov and corrcoef of b[:256]; concatenate, stack,
     tile, roll, pad, rot90, flip and array_split bit for bit; histogram
     with 1024 bins, interp of 2^26 points over 2^20 knots, convolve of
     2^24 values with 129 taps, diff, gradient, take_along_axis and
     packbits/unpackbits, each against NumPy (its comparisons on six host
     threads while the card works), the host seconds printed as in 16;
 18. the sorts, searches, order statistics and prefix scans at config 1's
     16384^2 float32 through the entry points: sp.sort/sp.argsort along
     each axis and of the raveled 2^28 elements, held on the card
     (non-decreasing, the argsort a stable permutation by bincount, the
     gather equal to the sort) and on sampled rows, columns and ranks
     against NumPy; stable argsorts of 2^26 keys with heavy int32 ties,
     with -0.0 beside +0.0 and with NaNs of both signs, exactly against
     NumPy's stable argsort; cumsum (float64) along an axis and raveled,
     cumprod, cummax/cummin carrying NaN; median, percentile([1, 50, 99])
     and nanmedian with NaN planted, whole and along an axis;
     searchsorted/digitize of 2^26 queries into 2^20 boundaries;
     permutation(2^26); a logaddexp scan_fn over 2^24 values; each item's
     device time on its own line, the host seconds printed as in 16;
 19. the loops and the Krylov solvers of sp.sparse.linalg in float32, each
     solve one sp.while_loop whose matvecs launch K3a or K3b: cg on a
     backward-Euler heat step (I + 100 L) u = u0 on a 2048^2 grid (K3b),
     again on a mesh of 8 shards (K3d; x and the iteration count bit for
     bit the unsharded run's), bicgstab and gmres(20) on an upwind
     convection-diffusion matrix of that grid, cg on the reference test's
     _sparse_spd and minres on a shifted graph Laplacian (indefinite) at
     n = 32768 (K3a), lsqr and lsmr on a 2^22 x 2^20 sparse system (K3b on
     A and A.T); each held to a float64 solve (scipy's, the heat step's in a
     worker process; a float64 CGLS on the card for the least squares) and
     to its true residual in float64 on the card, its launches to its
     matvec count; then each solve's host and device ms an iteration (the
     sync an iteration of while_loop's host-read condition included);
     scan_iters over 50 PageRank steps on phase 6's 32768-node graph
     against make_fori, and cond both ways;
 20. sp.sparse's builders, sp.linalg, sp.fft, sp.random and array files:
     the 5-point Laplacian of a 2048^2 grid (n = 2^22) and of a 128 x 256
     grid (n = 32768) by sp.sparse.kronsum of two sp.sparse.diags, each
     equal to scipy's kronsum, and sp.linalg.eigvalsh_lanczos(L, k=6) on
     each through K3b and K3a (one launch a Lanczos step), within
     lanczos_tol of a float64 run and at most the closed-form top
     eigenvalues, then (outside the counted run) K3b on the 2^22
     Laplacian's CSR and K3a on the 32768 one's ELL against their plain
     versions on a seeded x; K3b's wrapper timed on the 32768 Laplacian beside K3a's
     (the ELL/CSR crossover); sp.sparse.random at 2^22 x 2^22 with 16
     entries a row (exactly round(density m n) distinct positions) and
     its sp.sparse.linalg.norm through K1; at config 3's X (2^20 x 64
     float64) lstsq, qr('tsqr'), svd_lowrank and pca.fit, cholesky of an
     8192^2 SPD matrix and solve('cholesky'), eigh, svd, inv and slogdet
     at 4096^2 (a first call and a second one timed), each against NumPy's float64 result on six host threads;
     sp.fft at config 1's 16384^2 float32 (fft2/ifft2 and rfft2/irfft2
     round trips, Parseval), NumPy's FFT at 4096^2, Poisson's spectral
     solve at 16384^2 by its residual through laplacian and at 4096^2
     against NumPy; 2^28 normals and 2^24 draws each of gamma, beta,
     poisson and binomial held to their first two moments; save/load of
     a 16384^2 float32 array bit for bit, a checkpoint inside a DAG and
     from_file; the phase's host seconds printed by kind;
 21. the spectral solvers of sp.sparse.linalg in float32, each Arnoldi
     step one K3a or K3b launch: eigsh(k=6, 'LA') on the 2048^2 grid's
     Laplacian (K3b, 20 fused restart cycles: a budget, held by Weyl's
     bound and Cauchy's interlacing against the closed-form spectrum) and
     on the 128 x 256 grid's (K3a, to convergence, against the closed
     form), eigsh by shift-invert at sigma = 1e-3 there (each matvec a
     minres solve, its K3a launches counted), each eigsh's host and device
     ms a restart cycle; eigs on an upwind convection-diffusion operator of
     the 128 x 256 grid against its closed form (Bauer-Fike) and ARPACK;
     svds(k=10) of ratings of MovieLens 20M's shape (A x on K3a, A.T y on
     K3b) against scipy's float64 svds on the host; expm_multiply of the
     2^22 Laplacian at t = 1 against its DST-I sine modes; LaplacianNd's
     matvec at 2048^2 against the kronsum Laplacian through K3b, eigsh on
     LaplacianNd((128, 256)) against its eigenvalues(), the periodic
     matvec timed; sp.scipy_linalg at 4096^2 float64 (expm against eigh,
     the backward errors of lu_factor/lu_solve and cho_factor/cho_solve,
     sqrtm, logm and signm with no gate fallback, polar, orth and
     null_space of a rank-4000 matrix) and at 1024^2 against scipy on
     six host threads; the densified expm, inv, matrix_power and
     spsolve_triangular at n = 4096; each host boundary once, counted;
 22. autodiff and sp.sparse.csgraph: sp.compile of config 1's
     sum(abs(1 + 2b)) called on 5 fresh b's (5 K1 launches, each held to
     NumPy's float64) and of one PageRank step on phase 6's urand 2^22
     graph called 30 times (30 K3b launches, held to phase 6's float64
     ranks); grad, value_and_grad, hvp, hessian and jvp of a least-squares
     loss at config 3's 2^20 x 64 float64 against their hand forms, grad
     through SpMV on urand 2^22 against A.T c (K3b on the transpose) and
     through SpMM at ML-20M's shape against 2 R.T (R B), none of them moving
     a kernel's count; sp.minimize of a logistic loss there against
     scipy's BFGS; convnet's fit_fused and train at MNIST's test-set shape
     and sgd_train with remat around the first block, with the peak device
     memory of each; dijkstra (unweighted and weighted) from 4 sources,
     weak components and the normed Laplacian of urand 2^22, the
     components of a 1024^2 grid cut in two (1535 rounds) and
     floyd_warshall at n = 4096, each against scipy.sparse.csgraph (the
     2^22 graph's and minimize's oracles in worker processes since the
     build; the compiled sums' NumPy oracles on six threads while the
     card works), with each loop's rounds and host and device ms a round;
 23. sp.optimize and sp.integrate in float64 (no kernel: their objectives
     lower with differentiable=True, onto the plain routes): curve_fit and
     least_squares ('lm', then 'trf' with p1 <= 1.25 binding) of the
     reference test's p0 exp(-p1 t) + p2 over 2^20 samples on the card,
     each parameter within 1e-7 of scipy's least_squares; BFGS on the
     64-parameter Rosenbrock function from zeros to the reference's
     outcome (its line search fails after 95 iterations, status 3, where
     scipy's BFGS converges) and the box solver in [-2, 0.8]^64 against
     scipy's L-BFGS-B; root of a 256-unknown cubic system to its known
     root; brentq, ridder, bisect and newton on 0-d tensors of the card
     to their closed forms; differential_evolution on the 8-D Rastrigin
     function to its global minimum and Nelder-Mead on the 4-D
     Rosenbrock function; solve_ivp RK45 (about 1000 steps) and RK23 of
     the method-of-lines heat equation with 65,536 unknowns from one sine
     mode of its Laplacian, held to exp(-lambda t) y0 within the steps
     times (atol + rtol); trapezoid, simpson, romb, cumulative_trapezoid
     and cumulative_simpson over 2^24 + 1 samples against NumPy and scipy
     (worst-case rounding of both sums); fixed_quad, tanhsinh and
     qmc_quad against their closed forms; one host boundary of each
     namespace, counted (scipy's oracles in the worker processes since
     the build), with the host and device ms a turn of the least-squares
     and RK45 loops.
 24. the remaining examples through learn's 14 estimators at full width:
     LinearRegression, LogisticRegression, SVC, Ridge and Lasso at config
     3's 2^20 x 64 float64, each held to its example's stepwise fit on the
     card (Ridge to a float64 solve, Lasso to lasso.fit_numpy in a worker),
     PCA to eigvalsh of the covariance, one FISTA step's host and device
     ms; GaussianMixture (to gmm.em_numpy from the same start in a
     worker), FuzzyKMeans and KMeans at config 4's 2^19 x 64 with k = 64,
     SpectralClustering on two rings of 4096 points; KNeighborsClassifier
     on 2^16 x 64 with 2^12 queries against NumPy's argpartition (a
     worker); NaiveBayes on 2^20 documents of 256 counts (drawn on the card
     in one call), both routes against each other and NumPy; netflix SGD at
     MovieLens 20M's shape (64 steps of 4096), fit against fit_compiled,
     the one-hot step against the scatter step within 16 ulps, one
     compiled step's host and device ms; learn.ALS (K5a) and
     learn.TruncatedSVD (K3a/K3b) on phase 21's ratings against als.fit
     and phase 21's svds; Black-Scholes on 2^26 options against
     price_numpy on 2^20 of them; sp.special's 116 device names at 2^24
     float64 points (the betainc and kolmogorov inverses at 2^18; four of
     them, betaincinv/betainccinv/stdtrit/fdtri, trimmed to phase 25's
     t/f/beta ppf and isf for the script's time, and bdtri/nbdtri/kolmogi
     to the CPU test for phase 26's), each
     held to scipy on 2^16 sampled points at the CPU test's bounds, the
     direct core again in float32, four names timed, every host name once
     through the counted boundary; every runner of the examples' CLI in
     process, and ``python -m spartan_tpu_torch.examples knn`` as a
     subprocess.
 25. sp.stats and sp.signal (no kernel: their maps are torch code): every
     method of the 24 device distributions at 2^22 float64 points with
     nontrivial loc, scale and shape (the betainc bisections, t.ppf,
     f.isf, beta.ppf, binom.cdf and nbinom.ppf, at 2^16; the other five to
     the CPU test for phase 26's time), each held to
     scipy on 2^16 of them, a float32 pass, 2^22 draws of each held to its
     own cdf by the KS bound at alpha 1e-6 (discrete: mean and variance);
     29 descriptive statistics on a 2^14 x 2^10 float64 matrix along axis
     0, 1 and None, 22 hypothesis tests on 2^20 samples with ties for the
     rank tests and gaussian_kde of 4096 3-D points at 2^16 points, all
     against scipy; convolve/correlate at 2^20 x 255, fftconvolve at
     2^22 x 4095, convolve2d on 4096^2, the spectra at 2^22 samples with
     the stft -> istft round trip, hilbert, resample, resample_poly,
     savgol, medfilt, medfilt2d, lombscargle, czt and the waveforms;
     lfilter/filtfilt at 2^14 and sosfilt/sosfiltfilt at 2^12 samples on
     256 channels and decimate, with lfilter's host and device us a
     sample; oscillator.run() within one Welch bin.  Its scipy oracles run
     in the worker processes from before the build.
 26. sp.ndimage and sp.spatial (their maps are torch code; sum_labels of a
     float32 image without labels is sp.sum, K1): gaussian (sigma 3),
     uniform (5), median (3), sobel on both axes and 3x3 and 5x5
     correlate on an 8192^2 float32 image, held to scipy's float32 on 64
     rows, and a sigma-2 Gaussian of a 256^3 volume; the 3x3 correlate
     timed at 16384^2 beside K4's row; binary_opening, binary_fill_holes
     and label of 8192^2 blobs (smoothed noise above one standard
     deviation) exactly scipy's, with the loops' rounds and host reads,
     and sum_labels, mean, maximum_position and center_of_mass over every
     label; zoom 1.5, rotate 30 degrees and map_coordinates of 2^22 points
     at order 1 on 4096^2; cdist of 8192 x 8192 points in 64 dimensions
     (euclidean, and cityblock in chunks), a KDTree's 8 nearest of 8192
     queries among 2^18 points (8 GB of tile in 1 GB chunks, the indices
     held to scipy's cKDTree where no near tie can swap them) and Rotation
     over 2^20 quaternions; each item's seconds and the phase's peak
     device memory.  Its scipy oracles run in the worker processes.

The count of each kernel's launches is set to 0 just before the path that
runs it (phases 3-4, 15, 16 and 17 for K1, phase 6 for K3a/K3b, phase 8 for
K5a, phase 10 for K6a, phase 11's full-size matmul calls and phase 16's
for K2, phase 12's
make_spmv_windowed calls for K3c, phase 14's path at each p for the
sharded kernels, summed over the three meshes, and each counted solve and
the scan of phase 19 for K3a, K3b and K3d, phase 20's two Lanczos
runs for K3b and K3a and its sparse norm for K1, each counted solve of
phase 21 for K3a and K3b, phase 22's compiled calls for K1 and K3b, and
phase 24's learn.ALS for K5a and learn.TruncatedSVD for K3a and K3b,
phase 26's sum_labels without labels for K1; phase 25's sp.stats and
sp.signal reach no kernel)
and read just after.  K4
has no caller in the package: its count is the launches of phase 9's
checks.  The
last two lines are a JSON object describing each kernel (its launches on
its path, its worst disagreement with the plain version, its time, the
plain version's, one library call's, and the card's bound for the same
work) and the result object ``{"ok": true, "device": {...}}``.  Without a
CUDA device it exits non-zero and prints no result.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import gc
import json
import multiprocessing
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np
import scipy.sparse as ss
import scipy.sparse.linalg as ssl
import torch
import torch.nn.functional as F

import spartan_tpu_torch as sp
from spartan_tpu_torch import csgraph as CG
from spartan_tpu_torch import sparse_linalg as spl
from spartan_tpu_torch.backend import sparse
from spartan_tpu_torch.backend.kernels import build
from spartan_tpu_torch.backend.kernels import fused_reduce as K
from spartan_tpu_torch.backend.kernels import matmul as K2
from spartan_tpu_torch.backend.kernels import spmm as K5
from spartan_tpu_torch.backend.kernels import spmv as KS
from spartan_tpu_torch.backend.kernels import stencil as K6
from spartan_tpu_torch.examples import (als, convnet, heat, kmeans,
                                        lanczos, linear_reg, logistic_reg,
                                        pagerank, pca, poisson)
from spartan_tpu_torch.expr.local import FnCallExpr, LocalConst, LocalInput
from spartan_tpu_torch.expr.map import UFUNCS
from spartan_tpu_torch.util import Timer

DEVICE = "cuda"
KERNELS = ("fused_reduce", "fused_reduce_rare1", "fused_reduce_rare",
           "spmv_ell", "spmv_csr", "spmm_csr", "stencil3x3",
           "stencil3x3_padded", "matmul", "spmv_chunked")
KERNEL_SHAPES = [((16384, 16384), torch.float32), ((8192, 8192), torch.bfloat16),
                 ((10_000_019,), torch.float32), ((13, 20), torch.float32)]
TIMED_SHAPE = (16384, 16384)
SUM_N = 16384
DOT_N = 4096
LINREG_N, LINREG_D, LINREG_STEPS, ALPHA = 1 << 20, 64, 5, 0.05
# PageRank: GAP urand graphs, scale 22 (cut from the suite's 27) and the
# n = 32768 shape at the ELL kernel's limit; config 5's block shape
PR_BIG_N, PR_SMALL_N, PR_DEGREE, PR_ITERS, DAMPING = 1 << 22, 32768, 16, 30, 0.85
CFG5_BLOCKS, CFG5_PER_ROW, CFG5_BS = 64, 8, 128
# ALS at the shape of GroupLens MovieLens 20M (Harper and Konstan, ACM TiiS
# 5(4), 2015): users, rated movies, ratings, the fewest ratings a user has,
# the most a user has and the most a movie has
ML_USERS, ML_MOVIES, ML_RATINGS = 138_493, 26_744, 20_000_263
ML_MIN_USER, ML_MAX_USER, ML_TOP_MOVIE = 20, 9_254, 67_310
# weights of the ratings 0.5, 1.0, ..., 5.0, shaped like the dataset's
# histogram (most at 4.0, then 3.0)
ML_RATING_WEIGHTS = (1.2, 3.4, 1.4, 7.2, 4.4, 21.4, 11.0, 27.8, 7.7, 14.5)
ALS_K, ALS_ITERS, ALS_REG = 64, 5, 0.1
SPMM_KS = (1, 3, 64, 130, 512)
# K5a's long-row checks: k, and the rows of a skewed 2000 x 90,000 matrix
# (short rows of 0-40 entries besides): 0, 1, SEG-1, SEG, SEG+1, 2·SEG and
# 7·SEG+3 entries and one of 70,000, each in its own row band at p = 8
SKEW_KS = (1, 3, 4, 31, 64, 130, 512)
SKEW_N, SKEW_M = 2000, 90_000
SKEW_ROWS = {5: 0, 140: 1, 300: K5.SEG - 1, 520: K5.SEG, 700: K5.SEG + 1,
             1030: 2 * K5.SEG, 1290: 7 * K5.SEG + 3, 1500: 70_000}
# 3x3 stencils: check shapes, coefficient sets, and the full grid (config
# 1's 16384^2) swept by heat (alpha 0.1) and weighted Jacobi
STENCIL_SHAPES = ((1, 1), (3, 5), (13, 20), (64, 256), (1000, 1001),
                  (4097, 130))
LAPLACIAN = (0.0, 1.0, 0.0, 1.0, -4.0, 1.0, 0.0, 1.0, 0.0)
NINE = (0.05, 0.1, 0.02, 0.1, 0.4, -0.1, 0.3, 0.1, 0.03)
HEAT_ALPHA = 0.1
HEAT = (0.0, HEAT_ALPHA, 0.0, HEAT_ALPHA, 1.0 - 4.0 * HEAT_ALPHA, HEAT_ALPHA,
        0.0, HEAT_ALPHA, 0.0)
JACOBI = (0.0, 0.25, 0.0, 0.25, 0.0, 0.25, 0.0, 0.25, 0.0)
GRID_N, SWEEPS, CHUNK = 16384, 200, 8
EXPR_N, EXPR_STEPS = 4096, 50
# MNIST's test set: 10,000 images of 1 x 28 x 28; the numpy oracle takes
# the first CONV_CHECK
MNIST_SHAPE, CONV_CHECK = (10_000, 1, 28, 28), 256
# K2: (M, K, N) check shapes; config 2's published 32768^2 float32
# (BASELINE.json configs[1]); bench.py's own config-2 run, 8192^2 bfloat16
# the last three: a full 128 x 256 tile of the 16-bit kernel, ragged last
# tiles in M and N with K = 4·64 - 1, and K = 3·64 - 1 with N % 8 != 0
MATMUL_SHAPES = ((1, 1, 1), (17, 33, 65), (1000, 1001, 999), (64, 256, 128),
                 (128, 64, 256), (257, 255, 250), (300, 191, 520))
CFG2_N, BENCH_MM_N, CFG2_REPS = 32768, 8192, 3
# k-means at bench.py's config-4 shape; logistic regression at config 3's
KM_N, KM_D, KM_K, KM_ITERS = 1 << 19, 64, 64, 10
LOGREG_STEPS, LOGREG_ALPHA = 50, 1.0
TIMING_REPS = 7
SPIN_CYCLES = 20_000_000  # about 10 ms of an H100 SM clock
# H100 SXM: HBM rate, the float32 rate outside the tensor cores and the
# dense bfloat16/float16 tensor-core rate
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BF16_FLOPS = 989e12


# host seconds a phase spends outside its items, by kind (phases 16-17)
HOST_SPANS: dict = {}


@contextlib.contextmanager
def host_span(name: str):
  t0 = time.perf_counter()
  try:
    yield
  finally:
    HOST_SPANS[name] = HOST_SPANS.get(name, 0.0) + time.perf_counter() - t0


def print_host_spans(phase: int, wall: float) -> None:
  """The phase's wall split by kind (``items``: the items' own walls,
  device work and fetches), the rest unnamed host work."""
  named = sum(HOST_SPANS.values())
  parts = ", ".join(f"{k} {v:.2f} s" for k, v in sorted(HOST_SPANS.items()))
  print(f"  phase {phase} wall {wall:.2f} s: {parts}, other "
        f"{wall - named:.2f} s; host work outside the items "
        f"{wall - HOST_SPANS.get('items', 0.0):.2f} s")
  HOST_SPANS.clear()


def check(cond: bool, msg: str) -> None:
  if not cond:
    raise RuntimeError(msg)


def rel_err(got: float, want: float) -> float:
  return abs(got - want) / max(abs(want), 1e-300)


def card_line() -> str:
  out = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
      capture_output=True, text=True, check=True, timeout=60).stdout
  return out.strip().splitlines()[0]


def bound(nbytes: float, flops: float, peak: float = F32_FLOPS):
  """(least ms for this work on an H100 SXM, which of the two bounds it);
  ``peak`` is the rate of the operations' type."""
  t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
  return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                     else "operations")


def call(name, *deps):
  return FnCallExpr(UFUNCS[name], list(deps))


V, S = LocalInput(0), LocalInput(1)
# name → (chain, uses exp/log, takes a runtime scalar)
CHAINS = {
    "identity": (None, False, False),
    "1+2v": (call("add", LocalConst(1.0), call("multiply", V, LocalConst(2.0))),
             False, False),
    "abs(1+2v)": (call("absolute", call("add", LocalConst(1.0),
                                        call("multiply", V, LocalConst(2.0)))),
                  False, False),
    "exp(-v*v)": (call("exp", call("multiply", call("negative", V), V)),
                  True, False),
    "max(v*s,0.25)": (call("maximum", call("multiply", V, S), LocalConst(0.25)),
                      False, True),
    # power with a general exponent (powf/pow: the CUDA math library's ulp
    # bounds, so "transcendental"), with 2 (the square instruction), floor
    # division and remainder (torch's algorithm, IEEE-rounded steps)
    "abs(v)**2.5": (call("power", call("absolute", V), LocalConst(2.5)),
                    True, False),
    "power(v,2)": (call("power", V, LocalConst(2.0)), False, False),
    "v//0.3": (call("floor_divide", V, LocalConst(0.3)), False, False),
    "v%0.7": (call("remainder", V, LocalConst(0.7)), False, False),
}

def _sum(*terms):
  out = terms[0]
  for t in terms[1:]:
    out = call("add", out, t)
  return out


def _scaled(c):
  return call("multiply", V, LocalConst(c))


_ABS1 = call("add", call("absolute", V), LocalConst(1.0))
# the trig, hyperbolic, rounding and log/exp ops (the rare variants): each
# of the 31 in a chain; "oracle" chains are also held to a float64
# evaluation on the card (their arguments pass CUDA sinf's fast reduction,
# 105615, and reach 1e30)
NEW_CHAINS = {
    "sin(1e6v)": (call("sin", _scaled(1e6)), True, False),
    "trig(1e30v)": (_sum(call("sin", _scaled(1e30)),
                         call("cos", _scaled(1e30)),
                         call("tan", _scaled(3e29))), True, False),
    "floor(3v)": (call("floor", _scaled(3.0)), False, False),
    "tanh(0.5v)": (call("tanh", _scaled(0.5)), True, False),
    "log1p(abs(v))": (call("log1p", call("absolute", V)), True, False),
    "arctan2(v,0.5)": (call("arctan2", V, LocalConst(0.5)), True, False),
    "hypot(v,2)": (call("hypot", V, LocalConst(2.0)), True, False),
    "ceil+trunc+rint": (_sum(call("ceil", _scaled(3.0)),
                             call("trunc", _scaled(3.0)),
                             call("rint", _scaled(3.0))), False, False),
    "asin+acos+atan": (_sum(call("arcsin", _scaled(0.3)),
                            call("arccos", _scaled(0.3)),
                            call("arctan", V)), True, False),
    "hyperbolic": (_sum(call("sinh", V), call("cosh", V), call("arcsinh", V),
                        call("arccosh", _ABS1),
                        call("arctanh", _scaled(0.3))), True, False),
    "exp2..cbrt": (_sum(call("exp2", V), call("expm1", V),
                        call("log2", _ABS1), call("log10", _ABS1),
                        call("cbrt", V)), True, False),
    "erf+erfc": (_sum(call("erf", V), call("erfc", V)), True, False),
    "copysign+fmax+fmin": (_sum(call("copysign", V, call(
        "subtract", V, LocalConst(0.5))), call("fmax", V, LocalConst(0.5)),
        call("fmin", V, LocalConst(0.5))), False, False),
    "logaddexp(2)": (_sum(call("logaddexp", V, LocalConst(0.5)),
                          call("logaddexp2", V, _scaled(0.5))), True, False),
}
ORACLE_CHAINS = ("sin(1e6v)", "trig(1e30v)")
ALL_CHAINS = {**CHAINS, **NEW_CHAINS}
# K1's abs(1+2v) at 16384^2 float32 before this op table grew (PERF.md,
# PR 8): the new opcodes must not cost it more than 3 %
K1_ABS_MS_PR8 = 0.4680


def tolerance(transcendental: bool, acc: torch.dtype) -> float:
  if acc == torch.float32:
    return 1e-5   # float32 accumulation in another order
  if transcendental:
    return 1e-6   # exp/log differ by an ulp between CUDA and torch
  return 1e-9     # IEEE-rounded chain, float64 sum: only the order differs


def event_ms(fn, inner: int = 1):
  """(device ms, host ms to issue, queued ahead) per call of ``fn`` over
  ``inner`` back-to-back calls.  The calls are queued behind a spin kernel
  (``torch.cuda._sleep``) that outlasts their issue, so the CUDA events time
  the device running them back to back, not the host issuing them; the
  spin is lengthened until it outlasts the issue (``queued ahead``), unless
  the issue waited for the spin to end (a blocking copy in the call)."""
  cycles = SPIN_CYCLES
  for _ in range(4):
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    marks[0].record()
    torch.cuda._sleep(cycles)
    marks[1].record()
    t0 = time.perf_counter()
    for _ in range(inner):
      fn()
    host = (time.perf_counter() - t0) * 1e3
    marks[2].record()
    marks[2].synchronize()
    spin = marks[0].elapsed_time(marks[1])
    ahead = host < 0.5 * spin
    if ahead or host >= spin:  # a longer spin would be waited for too
      break
    cycles *= 4
  return marks[1].elapsed_time(marks[2]) / inner, host / inner, ahead


def time_in_turns(fns, inner: int = 1, reps: int = TIMING_REPS):
  """Median device ms of each of ``fns`` (name → callable) over ``reps``
  samples, timed in turns; under ``name + ' host'`` the median host ms to
  issue one call, and under ``name + ' ahead'`` whether every sample was
  queued ahead."""
  for fn in fns.values():
    fn()
  samples = {name: [] for name in fns}
  hosts = {name: [] for name in fns}
  aheads = {name: True for name in fns}
  for _ in range(reps):
    for name, fn in fns.items():
      dev, host, ahead = event_ms(fn, inner)
      samples[name].append(dev)
      hosts[name].append(host)
      aheads[name] = aheads[name] and ahead
  out = {name: statistics.median(v) for name, v in samples.items()}
  out.update({f"{name} host": statistics.median(v)
              for name, v in hosts.items()})
  out.update({f"{name} ahead": v for name, v in aheads.items()})
  return out


def ptxas_report(source: str, entry: str):
  """ptxas's report of each kernel of ``source`` whose mangled name holds
  ``entry``: (mangled name, registers, stack frame bytes, spill store
  bytes, spill load bytes), from the build log."""
  rows, name, frame = [], None, None
  for line in build.build_log(source).splitlines():
    if "Function properties for" in line:
      name = line.split("Function properties for", 1)[1].strip()
    elif name and "stack frame" in line:
      frame = [int(w) for w in line.replace(",", " ").split() if w.isdigit()]
    elif name and "Used" in line and "registers" in line and frame:
      regs = int(line.split("Used", 1)[1].split()[0])
      if entry in name:
        rows.append((name, regs, *frame[:3]))
      name, frame = None, None
  return rows


def check_ptxas(source: str, entry: str, label: str) -> None:
  """Prints ptxas's line for each kernel ``entry`` of ``source`` and holds
  each to a 0-byte stack frame and no spill."""
  rows = ptxas_report(source, entry)
  check(rows, f"no ptxas report of {entry} in {source}'s build log")
  for name, regs, frame, stores, loads in rows:
    print(f"  ptxas {label} {name[-48:]}: {regs} registers, {frame} bytes "
          f"stack frame, {stores} bytes spill stores, {loads} bytes spill "
          f"loads")
    check(frame == 0 and stores == 0 and loads == 0,
          f"{label} {name} has a stack frame or spills")


def phase_kernel_vs_plain(device, card: str):
  """K1 against fused_sum_plain on the same card tensors."""
  check_ptxas("fused_reduce", "fused_sum_partials", "K1")
  check_ptxas("fused_reduce_rare1", "fused_sum_partials", "K1 rare, 1 reg")
  check_ptxas("fused_reduce_rare", "fused_sum_partials", "K1 rare")
  worst_abs = 0.0
  gen = torch.Generator(device=device).manual_seed(1234)
  launches0 = K.counts["launches"]
  n_cases = 0
  for shape, dtype in KERNEL_SHAPES:
    whole = (torch.rand(shape, generator=gen, device=device) * 3 - 1).to(dtype)
    s = torch.tensor(0.7, dtype=torch.float32, device=device)
    # the tensor, and its flattened x[1:]: a base off 16-byte alignment
    for view, x in (("", whole), (" [1:]", whole.reshape(-1)[1:])):
      for name, (chain, transcendental, has_scalar) in ALL_CHAINS.items():
        scalars = [s] if has_scalar else []
        program = K.plan(chain, 0, dtype, dict(enumerate(scalars, start=1)))
        check(program is not None, f"chain {name} did not translate")
        # a new chain's sum may cancel (sin, tan): its error is read
        # against the sum of |values|, which bounds what the per-element
        # differences can add up to
        scale = (K.evaluate_program(program, x, scalars).double().abs()
                 .sum().item() if name in NEW_CHAINS else None)
        for acc in (torch.float32, torch.float64):
          got = K.fused_sum(x, program, scalars, acc).item()
          again = K.fused_sum(x, program, scalars, acc).item()
          want = K.fused_sum_plain(x, program, scalars, acc).item()
          tol = tolerance(transcendental, acc)
          err = (rel_err(got, want) if scale is None
                 else abs(got - want) / max(scale, 1e-300))
          worst_abs = max(worst_abs, abs(got - want))
          print(f"  K1 {name:14s} {str(tuple(shape)) + view:21s} "
                f"{str(dtype)[6:]:8s} acc={str(acc)[6:]:7s} kernel={got:.17g} "
                f"plain={want:.17g} rel_err={err:.3g} (rtol {tol:g}); "
                f"repeat bitwise equal: {got == again}")
          check(np.isfinite(got) and err <= tol,
                f"K1 disagrees with its plain version: {name} {shape}{view} "
                f"{dtype} {acc}: {got} vs {want}")
          check(got == again, f"K1 is not deterministic: {name} {shape}{view}")
          n_cases += 2
    del x, whole
  torch.cuda.synchronize()
  check(K.counts["launches"] == launches0 + n_cases,
        f"launches rose by {K.counts['launches'] - launches0}, expected "
        f"{n_cases}")
  check_against_float64(device, gen)
  # time at the main path's shape: abs(1+2v) over 16384^2 float32, float64
  # accumulation; kernel and plain in turns, with every chain of CHAINS (the
  # identity program among them) and torch.sum(dtype=float64), the library
  # call for that program
  x = torch.randn(TIMED_SHAPE, generator=gen, device=device)
  s = torch.tensor(0.7, dtype=torch.float32, device=device)
  program = K.plan(CHAINS["abs(1+2v)"][0], 0, torch.float32, {})
  fns = {"plain": lambda: K.fused_sum_plain(x, program, [], torch.float64)}
  programs = {}
  for name, (chain, _, has_scalar) in ALL_CHAINS.items():
    scalars = [s] if has_scalar else []
    programs[name] = K.plan(chain, 0, torch.float32,
                            dict(enumerate(scalars, start=1)))
    fns[name] = (lambda p=programs[name], sc=scalars:
                 K.fused_sum(x, p, sc, torch.float64))
  fns["torch.sum"] = lambda: torch.sum(x, dtype=torch.float64)
  t = time_in_turns(fns)
  t["kernel"] = t["abs(1+2v)"]
  nbytes = x.numel() * x.element_size()
  bound_ms, bound_by = bound(nbytes + 8, x.numel() * len(program.instrs))
  print(f"  K1 time at {TIMED_SHAPE} float32, abs(1+2v), float64 acc: "
        f"kernel {t['kernel']:.4f} ms ({nbytes / t['kernel'] / 1e6:.1f} GB/s; "
        f"{100 * (t['kernel'] / K1_ABS_MS_PR8 - 1):+.2f} % against PR 8's "
        f"{K1_ABS_MS_PR8} ms), "
        f"plain {t['plain']:.4f} ms, torch.sum(dtype=float64) "
        f"{t['torch.sum']:.4f} ms; bound {bound_ms:.4f} ms ({bound_by}) "
        f"(median of {TIMING_REPS}, queued ahead of the device, CUDA events, "
        f"in turns) on {card}")
  for name, p in programs.items():
    print(f"  K1 chain {name:14s} {t[name]:.4f} ms: {len(p.instrs)} "
          f"instructions, {1 + max(d for _, _, d, _, _ in p.instrs)} "
          f"register(s), {'float' if p.float_regs else 'double'} registers "
          f"on {card}")
  return {"max_abs_err": worst_abs, "ms": t["kernel"], "plain_ms": t["plain"],
          "library_ms": t["torch.sum"], "bound_ms": bound_ms,
          "bound_by": bound_by}


def check_against_float64(device, gen, names=ORACLE_CHAINS) -> None:
  """The large-argument chains at 16384^2 float32 against a float64
  evaluation of the same float32 arguments on the card: the kernel's
  sin/cos/tan must be within an ulp an element, so the sums within
  2^-23 of the sum of |values| (CUDA's __sinf, wrong past |x| ~ pi, fails
  it: tools/torch_k1k2_mutation.py).  The plain version (torch's sinf)
  is held to the same bound."""
  x = torch.rand(TIMED_SHAPE, generator=gen, device=device) * 3 - 1
  for name in names:
    program = K.plan(NEW_CHAINS[name][0], 0, torch.float32, {})
    if name == "sin(1e6v)":
      want_v = torch.sin((x * 1e6).double())
    else:
      want_v = (torch.sin((x * 1e30).double()) + torch.cos(
          (x * 1e30).double()) + torch.tan((x * 3e29).double()))
    want = want_v.sum().item()
    bound_abs = 2.0 ** -23 * want_v.abs().sum().item()
    del want_v
    got = K.fused_sum(x, program, [], torch.float64).item()
    plain = K.fused_sum_plain(x, program, [], torch.float64).item()
    print(f"  K1 {name} at {TIMED_SHAPE} float32 against float64 on the "
          f"card: kernel {got:.17g}, plain {plain:.17g}, float64 "
          f"{want:.17g}; |kernel - float64| {abs(got - want):.4g}, |plain "
          f"- float64| {abs(plain - want):.4g}, bound {bound_abs:.4g} "
          f"(2^-23 of the sum of |values|: an ulp an element)")
    check(abs(got - want) <= bound_abs,
          f"K1 {name} strays from the float64 evaluation: {got} vs {want}")
    check(abs(plain - want) <= bound_abs,
          f"the plain {name} strays from the float64 evaluation")
  del x


def phase_map_reduce_and_dot(rng):
  b_host = rng.standard_normal((SUM_N, SUM_N), dtype=np.float32)
  b = sp.from_numpy(b_host)
  before = K.counts["launches"]
  with Timer() as t_affine:
    affine = float((sp.ones((SUM_N, SUM_N)) + b * 2).sum().glom())
  check(K.counts["launches"] == before,
        "the affine sum launched K1; it must take the affine rewrite")
  with Timer() as t_fused:
    fused = float(abs(1 + b * 2).sum().glom())
  check(K.counts["launches"] == before + 1,
        "abs(1 + b*2).sum() did not launch K1")
  b64 = b_host.astype(np.float64)
  want_affine = float((1.0 + 2.0 * b64).sum())
  del b64
  # the chain computes in float32 (weak scalars), the sum in float64
  want_fused = float(np.abs(np.float32(1) + b_host * np.float32(2)).sum(
      dtype=np.float64))
  for label, got, want, secs in (("(ones + b*2).sum()", affine, want_affine,
                                  t_affine),
                                 ("abs(1 + b*2).sum()", fused, want_fused,
                                  t_fused)):
    err = rel_err(got, want)
    print(f"  {label} at {SUM_N}^2 float32: {got:.17g} vs NumPy "
          f"{want:.17g}, rel_err {err:.3g} (rtol 1e-9), wall "
          f"{secs.elapsed * 1e3:.1f} "
          "ms incl. first-call setup")
    check(err <= 1e-9, f"{label} disagrees with the NumPy oracle")
  del b, b_host

  a_host = rng.standard_normal((DOT_N, DOT_N), dtype=np.float32)
  c_host = rng.standard_normal((DOT_N, DOT_N), dtype=np.float32)
  with Timer() as t_dot:
    out = sp.dot(sp.from_numpy(a_host), sp.from_numpy(c_host)).glom()
  rows = rng.choice(DOT_N, 64, replace=False)
  want = a_host[rows].astype(np.float64) @ c_host.astype(np.float64)
  check(out.dtype == np.float64 and out.shape == (DOT_N, DOT_N),
        f"dot gave {out.dtype} {out.shape}")
  # rtol 1e-10 elementwise, with an absolute floor of 1e-10 * max|ref| for
  # entries that cancel to near zero (float64 sums in another order)
  err = np.abs(out[rows] - want).max() / np.abs(want).max()
  print(f"  dot {DOT_N}^2 float32 (float64 accumulation): max err "
        f"{err:.3g} of max|ref| on 64 rows (rtol 1e-10), wall "
        f"{t_dot.elapsed * 1e3:.1f} ms incl. transfers")
  np.testing.assert_allclose(out[rows], want, rtol=1e-10,
                             atol=1e-10 * np.abs(want).max())


def phase_training(rng):
  X_host = rng.standard_normal((LINREG_N, LINREG_D))
  y_host = X_host @ rng.standard_normal(LINREG_D) + 0.01 * rng.standard_normal(
      LINREG_N)
  X, y = sp.from_numpy(X_host), sp.from_numpy(y_host)
  torch.cuda.synchronize()
  with Timer() as t_fit:
    w = linear_reg.fit(X, y, LINREG_STEPS, ALPHA).glom()
  w_np = np.zeros(LINREG_D)
  for _ in range(LINREG_STEPS):
    w_np = w_np - ALPHA * (X_host.T @ (X_host @ w_np - y_host)
                           * (2.0 / LINREG_N))
  err = np.abs(w - w_np).max() / np.abs(w_np).max()
  print(f"  linear_reg.fit n={LINREG_N} d={LINREG_D} float64, "
        f"{LINREG_STEPS} steps: max rel err vs NumPy {err:.3g} (rtol 1e-9); "
        f"{t_fit.elapsed / LINREG_STEPS * 1e3:.3f} ms/step incl. first-step setup")
  np.testing.assert_allclose(w, w_np, rtol=1e-9)
  run = sp.make_fori(
      lambda w_: linear_reg.gradient_step(X, y, w_, ALPHA),
      sp.zeros((LINREG_D,)))
  w_fori = run(LINREG_STEPS).glom()
  np.testing.assert_allclose(w_fori, w, rtol=1e-12)
  torch.cuda.synchronize()
  with Timer() as t_fori:
    run(LINREG_STEPS).data.sum().item()
  print(f"  make_fori: equals fit at rtol 1e-12; steady "
        f"{t_fori.elapsed / LINREG_STEPS * 1e3:.3f} ms/step (host clock, synced)")


# -- sparse ---------------------------------------------------------------------

def urand_graph(n: int, seed: int):
  """GAP's urand graph as a column-stochastic float32 link matrix: node j
  has PR_DEGREE out-edges to uniformly random targets i, A[i, j] = 1/16
  per edge (a repeated edge adds up), no dangling column."""
  rng = np.random.default_rng(seed)
  dst = rng.integers(0, n, n * PR_DEGREE, dtype=np.int32)
  data = np.full(n * PR_DEGREE, 1.0 / PR_DEGREE, dtype=np.float32)
  indptr = np.arange(0, n * PR_DEGREE + 1, PR_DEGREE, dtype=np.int64)
  return ss.csc_matrix((data, dst, indptr), shape=(n, n))


def config5_graph():
  """The block-structured link matrix of the reference's config 5
  (bench.py's bench_pagerank_step): 64 block-rows of 128, 8 random blocks a
  row, column-normalised, float32."""
  rng = np.random.default_rng(0)
  n = CFG5_BLOCKS * CFG5_BS
  cols_b = rng.integers(0, CFG5_BLOCKS, CFG5_BLOCKS * CFG5_PER_ROW)
  data = rng.random((CFG5_BLOCKS * CFG5_PER_ROW, CFG5_BS, CFG5_BS)).astype(
      np.float32)
  A = ss.bsr_matrix((data, cols_b, np.arange(CFG5_BLOCKS + 1) * CFG5_PER_ROW),
                    shape=(n, n)).tocsr()
  A = A @ ss.diags(1.0 / np.maximum(np.asarray(A.sum(axis=0)).ravel(), 1e-9))
  return A.tocsr().astype(np.float32)


def small_cases():
  """Odd shapes: random, a band of empty rows, one row of 10,000 entries,
  13 x 20."""
  rng = np.random.default_rng(7)
  cases = [("random 1500x2300 d=0.005",
            ss.random(1500, 2300, density=0.005, random_state=3,
                      format="csr", dtype=np.float32))]
  empty = ss.random(4096, 2500, density=0.004, random_state=4, format="lil",
                    dtype=np.float32)
  empty[2048:3072, :] = 0
  cases.append(("rows 2048-3071 empty", empty.tocsr()))
  long_row = ss.random(64, 20000, density=0.0003, random_state=5,
                       format="lil", dtype=np.float32)
  long_row[7, rng.choice(20000, 10_000, replace=False)] = rng.random(
      10_000).astype(np.float32)
  cases.append(("one row of 10000", long_row.tocsr()))
  cases.append(("13x20", ss.random(13, 20, density=0.3, random_state=6,
                                   format="csr", dtype=np.float32)))
  return cases


def spmv_cases(big, small):
  return [("urand 2^22", big), ("urand 32768", small)] + small_cases()


def drop_ell_lane(S, x, got, want, tol, label: str) -> None:
  """The check's power on K3a: ``got`` less lane 0's partial of the
  longest row (the products K3a's form gives lane 0 before the shuffle
  tree) must fail the check that ``got`` passed."""
  cols, vals = S.cols.contiguous(), S.vals.float().contiguous()
  on_chip, vec, group = KS.ell_form(cols, vals, x.shape[0])
  r = int((vals != 0).sum(1).argmax())
  k = cols.shape[1]
  width = 4 if on_chip else 1  # entries a lane's piece
  lane0 = [e for j in range(0, -(-k // width), group)
           for e in range(j * width, min((j + 1) * width, k))]
  part = float((vals[r, lane0].double()
                * x[cols[r, lane0].long()].double()).sum())
  bound = float(tol[r]) if torch.is_tensor(tol) else float(tol)
  err = abs(float(got[r]) - part - float(want[r]))
  print(f"  K3a on {label}: a result without lane 0's partial of row {r} "
        f"({len(lane0)} products, {width} a piece, {vec} a load, {group} "
        f"lanes) is off by "
        f"{err:.4g} against the bound {bound:.4g}")
  check(err > bound, f"K3a's check on {label} passes a result without "
        f"lane 0's partial")


def phase_spmv_kernels(device, card: str, big, small):
  """K3a/K3b against their plain versions on the card, then timed beside
  the plain versions and cuSPARSE."""
  check_ptxas("spmv_ell", "spmv_ell_onchip", "K3a on chip")
  check_ptxas("spmv_ell", "spmv_ell_l2", "K3a through L1")
  check_ptxas("spmv_csr", "spmv_csr_kernel", "K3b/K3d")
  sms = torch.cuda.get_device_properties(device).multi_processor_count
  print(f"  K3a's form: x copied whole into each block's shared memory for "
        f"m <= {KS.ELL_MAX_X} (one block an SM, {sms} SMs, no cluster), a "
        f"row's pieces of 4 entries a lane, loaded 16 bytes at a time where "
        f"k % 4 == 0 and the rows are aligned, else 4 bytes at a time (the "
        f"same sum); else gathered through L1; K3b and K3d read the CSR as "
        f"it is, x gathered from L2 (the form over x's windows in a "
        f"cluster's shared memory lost: PERF.md)")
  gen = torch.Generator(device=device).manual_seed(99)
  worst = {"spmv_ell": 0.0, "spmv_csr": 0.0}
  for label, A in spmv_cases(big, small):
    S = sparse.from_scipy(A)
    indptr, indices, data = S.to_csr()
    x = torch.randn(A.shape[1], generator=gen, device=device)
    long_row = label.startswith("one row")
    if long_row:
      # f32 sums of k terms in two orders: |diff| <= k 2^-24 sum|a x|
      sum_abs = KS.spmv_csr_plain(indptr, indices, data.abs(), x.abs())
      tol = S.max_nnz_per_row * 2.0 ** -24 * sum_abs
    for name, kernel, plain, args in (
        ("spmv_ell", KS.spmv_ell, KS.spmv_ell_plain, (S.cols, S.vals, x)),
        ("spmv_csr", KS.spmv_csr, KS.spmv_csr_plain,
         (indptr, indices, data, x))):
      got, want = kernel(*args), plain(*args)
      again = kernel(*args)
      torch.cuda.synchronize()
      diff = (got - want).abs()
      err = float(diff.max())
      worst[name] = max(worst[name], err)
      scale = float(want.abs().max())
      if long_row:
        ok = bool((diff <= tol).all())
        rule = "per-row k 2^-24 sum|a x|"
      else:
        ok = err <= 1e-5 * scale
        rule = "1e-5 max|y|"
      form = (" (on_chip, vec, group) = "
              f"{KS.ell_form(S.cols, S.vals, A.shape[1])}"
              if name == "spmv_ell" else "")
      print(f"  {name} {label:26s} {A.shape[0]}x{A.shape[1]} nnz={S.nnz} "
            f"k={S.max_nnz_per_row}{form}: max|kernel-plain| {err:.3g} "
            f"(max|y| {scale:.4g}, tolerance {rule}); "
            f"repeat bitwise equal: {bool(torch.equal(got, again))}")
      check(bool(torch.isfinite(got).all()) and ok,
            f"{name} disagrees with its plain version on {label}")
      check(torch.equal(got, again), f"{name} is not deterministic on {label}")
      if name == "spmv_ell" and label in ("urand 32768", "one row of 10000"):
        drop_ell_lane(S, x, got, want, tol if long_row else 1e-5 * scale,
                      label)
    del S, indptr, indices, data, x

  timings = {}
  for label, A, names, inner in (("urand 2^22", big, ("spmv_csr", "spmv_ell"), 20),
                                 ("urand 32768", small, ("spmv_ell",), 200)):
    S = sparse.from_scipy(A)
    indptr, indices, data = S.to_csr()
    n, m = S.shape
    k = S.max_nnz_per_row
    x = torch.randn(m, generator=gen, device=device)
    lib = torch.sparse_csr_tensor(indptr.int(), indices, data, size=(n, m),
                                  check_invariants=False)
    for name in names:
      if name == "spmv_csr":
        args = (indptr, indices, data, x)
        nbytes = S.nnz * 8 + (n + 1) * 8 + (m + n) * 4
        flops = 2 * S.nnz
      else:
        args = (S.cols, S.vals, x)
        nbytes = n * k * 8 + (m + n) * 4
        flops = 2 * n * k
      kernel = getattr(KS, name)
      plain = getattr(KS, f"{name}_plain")
      t = time_in_turns({"plain": lambda: plain(*args),
                         "kernel": lambda: kernel(*args),
                         "cuSPARSE": lambda: lib @ x}, inner)
      bound_ms, bound_by = bound(nbytes, flops)
      print(f"  {name} time on {label} (n={n}, nnz={S.nnz}, k={k}): kernel "
            f"{t['kernel']:.4f} ms ({S.nnz / t['kernel'] / 1e6:.2f} Gnnz/s, "
            f"{nbytes / t['kernel'] / 1e6:.1f} GB/s), plain "
            f"{t['plain']:.4f} ms, cuSPARSE {t['cuSPARSE']:.4f} ms, bound "
            f"{bound_ms:.4f} ms ({bound_by}, {nbytes / 1e6:.1f} MB) "
            f"(median of {TIMING_REPS} x {inner} calls queued ahead of the "
            f"device, CUDA events, in turns; queued ahead: "
            f"{all(t[f'{v} ahead'] for v in ('kernel', 'plain', 'cuSPARSE'))})"
            f"; host issue per call: kernel {t['kernel host']:.4f} ms, plain "
            f"{t['plain host']:.4f} ms, cuSPARSE {t['cuSPARSE host']:.4f} ms; "
            f"on {card}")
      timings[(name, label)] = {"ms": t["kernel"], "plain_ms": t["plain"],
                                "library_ms": t["cuSPARSE"],
                                "bound_ms": bound_ms, "bound_by": bound_by}
    del S, indptr, indices, data, x, lib
  # each kernel's numbers at the shape its main path gives it
  return {"spmv_csr": dict(timings[("spmv_csr", "urand 2^22")],
                           max_abs_err=worst["spmv_csr"]),
          "spmv_ell": dict(timings[("spmv_ell", "urand 32768")],
                           max_abs_err=worst["spmv_ell"])}


def scipy_pagerank(A) -> np.ndarray:
  A64 = ss.csr_matrix(A, dtype=np.float64)
  n = A64.shape[0]
  r = np.full(n, 1.0 / n)
  for _ in range(PR_ITERS):
    r = DAMPING * (A64 @ r) + (1.0 - DAMPING) / n
  return r


def pagerank_case(label: str, A, want_fmt: str, kernel_count,
                  stochastic: bool = True, oracle=None):
  """fit_sparse(from_scipy(A)) against scipy in float64 (``oracle``: a
  worker's future of it, else computed here); returns the
  SparseArray and the float64 ranks (phase 14 runs them again on sharded
  meshes).  ``kernel_count`` is the counts key that must
  rise by at least PR_ITERS, or None for the block route (no kernel).  A
  ``stochastic`` matrix (no dangling column) keeps the ranks' sum at 1."""
  n = A.shape[0]
  with Timer() as t_ingest:
    S = sparse.from_scipy(A)
  fmt = sparse.spmv_expr(S, sp.ones((n,), dtype=S.dtype)).fmt
  check(fmt == want_fmt, f"{label}: SpMVExpr took fmt {fmt!r}, not "
        f"{want_fmt!r}")
  before = dict(KS.counts)
  torch.cuda.synchronize()
  with Timer() as t_fit:
    r = pagerank.fit_sparse(S, iterations=PR_ITERS, damping=DAMPING)
  rose = {k: KS.counts[k] - before[k] for k in KS.counts}
  if kernel_count is None:
    check(not any(rose.values()), f"{label}: the block route launched an "
          f"SpMV kernel ({rose})")
  else:
    check(rose[kernel_count] >= PR_ITERS,
          f"{label}: {kernel_count} rose by {rose[kernel_count]}, expected "
          f">= {PR_ITERS}")
    check(rose["ell_plain_runs"] == rose["csr_plain_runs"] == 0,
          f"{label}: a card tensor reached a plain SpMV ({rose})")
  with Timer() as t_oracle:
    want = scipy_pagerank(A) if oracle is None else oracle.result()
  err = float(np.abs(r.astype(np.float64) - want).max())
  total = float(r.sum(dtype=np.float64))
  print(f"  PageRank {label} (n={n}, nnz={S.nnz}, fmt {fmt!r}): "
        f"{PR_ITERS} iterations, max|r - r64| {err:.3g} (<= 1e-5 max r64 = "
        f"{1e-5 * want.max():.3g}), |sum r - 1| {abs(total - 1):.3g} "
        f"({'<= 1e-4' if stochastic else 'dangling columns'}); launches {rose}; from_scipy {t_ingest.elapsed:.2f} s, "
        f"fit_sparse {t_fit.elapsed:.3f} s, scipy oracle "
        f"{t_oracle.elapsed:.2f} s{' (waited for its worker)' if oracle else ''}")
  check(r.shape == (n,) and r.dtype == np.float32
        and bool(np.isfinite(r).all()), f"{label}: bad ranks")
  check(err <= 1e-5 * want.max(), f"{label}: disagrees with scipy")
  check(not stochastic or abs(total - 1) <= 1e-4,
        f"{label}: ranks do not sum to 1")
  run = sp.make_fori(
      lambda r_: sparse.spmv_expr(S, r_) * DAMPING + (1.0 - DAMPING) / n,
      sp.ones((n,), dtype=S.dtype) / n)
  run(2).data.sum().item()
  torch.cuda.synchronize()
  with Timer() as t_steady:
    run(PR_ITERS).data.sum().item()
  ms = t_steady.elapsed / PR_ITERS * 1e3
  print(f"  make_fori steady {ms:.4f} ms/step, {S.nnz / ms / 1e6:.3f} "
        "Gnnz/s (host clock, synced)")
  return S, want


def urand_pagerank_oracle(n: int, seed: int) -> np.ndarray:
  """scipy's float64 PageRank of urand_graph(n, seed), in a worker
  process (45 s of one core at 2^22)."""
  return scipy_pagerank(urand_graph(n, seed))


def phase_pagerank(big, small, cfg5, big_oracle=None):
  """The three PageRank cases; returns the two urand graphs' SparseArrays
  and float64 ranks, by label.  ``big_oracle``: a worker's future of the
  2^22 graph's float64 ranks."""
  held = {"urand 2^22": pagerank_case("urand 2^22", big, "win",
                                      "csr_launches", oracle=big_oracle),
          "urand 32768": pagerank_case("urand 32768", small, "ell",
                                       "ell_launches")}
  pagerank_case("config-5 blocks", cfg5, "bsr", None, stochastic=False)
  return held

# -- SpMM and ALS ---------------------------------------------------------------

def user_lengths(rng) -> np.ndarray:
  """Ratings per user: ML_MIN_USER plus a power-law tail
  c·(r^-a - n^-a) over the ranks r = 1..n, which runs from ML_MAX_USER at
  rank 1 down to ML_MIN_USER at rank n, with a set so that the lengths sum
  to ML_RATINGS; the ranks are shuffled over the users."""
  n = ML_USERS
  ranks = np.arange(1, n + 1, dtype=np.float64)
  extra = ML_RATINGS - ML_MIN_USER * n

  def tail(a: float) -> np.ndarray:
    c = (ML_MAX_USER - ML_MIN_USER) / (1.0 - n ** -a)
    return np.floor(np.maximum(c * (ranks ** -a - n ** -a), 0)).astype(
        np.int64)

  lo, hi = 0.1, 2.0  # the tail's sum falls as a rises past 0.1
  for _ in range(60):
    mid = (lo + hi) / 2
    if tail(mid).sum() > extra:
      lo = mid
    else:
      hi = mid
  lengths = ML_MIN_USER + tail(hi)
  lengths[1:1 + extra - int(lengths.sum() - ML_MIN_USER * n)] += 1
  return rng.permutation(lengths)


def movielens_shaped(device, seed: int = 0):
  """A float32 scipy CSR ratings matrix of MovieLens 20M's shape, drawn on
  the card from ``seed``: user row lengths from :func:`user_lengths`; each
  user's movies drawn without replacement (so no duplicates) with
  Zipf-like popularity weights 1/(rank + j0), by the smallest of
  Exp(1)/weight keys; j0 set by bisection so that the most popular movie
  is rated by about ML_TOP_MOVIE of the users (estimated on 8192 users
  with fixed keys); popularity ranks shuffled over the movie ids; ratings
  0.5..5.0 from ML_RATING_WEIGHTS."""
  rng = np.random.default_rng(seed)
  lengths = user_lengths(rng)
  gen = torch.Generator(device=device).manual_seed(seed)
  L = torch.from_numpy(lengths).to(device)
  rank = torch.arange(ML_MOVIES, device=device, dtype=torch.float64)
  probe = torch.randperm(ML_USERS, generator=gen, device=device)[:8192]
  probe_keys = torch.empty((probe.shape[0], ML_MOVIES),
                           device=device).exponential_(generator=gen)

  def top_share(j0: float) -> float:
    keys = probe_keys * (rank + j0).float()
    return float(((keys < keys[:, :1]).sum(1) < L[probe]).double().mean())

  lo, hi = 1.0, 1e5  # a larger offset flattens the popularity
  for _ in range(40):
    mid = (lo * hi) ** 0.5
    if top_share(mid) * ML_USERS > ML_TOP_MOVIE:
      lo = mid
    else:
      hi = mid
  inv_weight = (rank + (lo * hi) ** 0.5).float()
  del probe_keys
  movie_of_rank = torch.randperm(ML_MOVIES, generator=gen, device=device)
  chunks = []
  for start in range(0, ML_USERS, 4096):
    Lc = L[start:start + 4096]
    width = int(Lc.max())
    keys = torch.empty((Lc.shape[0], ML_MOVIES), device=device).exponential_(
        generator=gen) * inv_weight
    ids = movie_of_rank[torch.sort(keys, dim=1).indices[:, :width]]
    keep = torch.arange(width, device=device) < Lc[:, None]
    ids = torch.where(keep, ids, ML_MOVIES).sort(dim=1).values
    chunks.append(ids[ids < ML_MOVIES].int())
    del keys, ids, keep
  indices = torch.cat(chunks)
  cdf = torch.tensor(np.cumsum(ML_RATING_WEIGHTS) / sum(ML_RATING_WEIGHTS),
                     device=device, dtype=torch.float32)
  draws = torch.rand(ML_RATINGS, generator=gen, device=device)
  data = (torch.searchsorted(cdf, draws, right=True).clamp_max(9).float()
          + 1) * 0.5
  indptr = np.concatenate([[0], np.cumsum(lengths)])
  return ss.csr_matrix((data.cpu().numpy(), indices.cpu().numpy(), indptr),
                       shape=(ML_USERS, ML_MOVIES))


def skewed_csr():
  """The float32 scipy CSR matrix of SKEW_ROWS, seeded."""
  rng = np.random.default_rng(47)
  lengths = rng.integers(0, 41, SKEW_N)
  for row, length in SKEW_ROWS.items():
    lengths[row] = length
  cols = np.concatenate([np.sort(rng.choice(SKEW_M, length, replace=False))
                         for length in lengths]).astype(np.int32)
  indptr = np.concatenate([[0], np.cumsum(lengths)])
  data = rng.standard_normal(indptr[-1]).astype(np.float32)
  return ss.csr_matrix((data, cols, indptr), shape=(SKEW_N, SKEW_M))


# Two float32 sums of the same n random-signed terms t in another order:
# the rounding errors add like a random walk, so they differ by about
# 0.8·sqrt(n)·2^-24·sqrt(Σt²) (one standard deviation) for sequential sums.
# STAT_C is that bound's multiple, about three times the largest share read
# over the 2^30 entries of the 32768^2 product (PERF.md §6).  Up to
# STAT_C/2 + 1 terms it is no looser than the worst case.
STAT_C = 16.0


def sum_bound(terms, abs_sum, sq_sum, worst):
  """The smaller of the worst case worst·n·2^-24·Σ|t| and the random-walk
  bound STAT_C·sqrt(n)·2^-24·sqrt(Σt²)."""
  return torch.minimum(worst * terms * 2.0 ** -24 * abs_sum,
                       STAT_C * terms ** 0.5 * 2.0 ** -24 * sq_sum.sqrt())


def spmm_tolerance(indptr, indices, data, B):
  """Per entry the smaller of 2·len(row)·2^-24·Σ|a_p·b_p,c| (both sides
  sum the same rounded float32 products, in another order) and the
  random-walk bound on Σ(a_p·b_p,c)² (sum_bound)."""
  lengths = (indptr[1:] - indptr[:-1]).double()[:, None]
  Bf = B.float()
  sum_abs = K5.spmm_csr_plain(indptr, indices, data.abs(), Bf.abs())
  sum_sq = K5.spmm_csr_plain(indptr, indices, data.square(), Bf.square())
  return sum_bound(lengths, sum_abs.double(), sum_sq.double(), 2.0)


def drop_partials(csr, B, got, want, tol):
  """The check's power on K5a's split rows: for the longest row, ``got``
  without that row's partial rows after the first 32 (one step of pass 2
  at k = 64: a pass 2 that stopped there), and ``got`` without its last
  segment.  Returns the row, its segments and each mutant's worst share
  of the row's bound (above 1: the check rejects it)."""
  indptr, indices, data = csr
  r = int((indptr[1:] - indptr[:-1]).argmax())
  s, e = int(indptr[r]), int(indptr[r + 1])
  segs = -(-(e - s) // K5.SEG)

  def without(lo, hi):
    part = (data[lo:hi].double()[:, None]
            * B.double()[indices[lo:hi].long()]).sum(0)
    bad = got[r].double() - part
    return float(((bad - want[r].double()).abs() / tol[r]).max())

  return (r, segs, without(min(e, s + 33 * K5.SEG), e),
          without(s + (segs - 1) * K5.SEG, e))


def spmm_check(label, csr, B):
  """K5a against its plain version on ``csr`` and ``B``; returns the worst
  |kernel - plain|."""
  got = K5.spmm_csr(*csr, B)
  again = K5.spmm_csr(*csr, B)
  want = K5.spmm_csr_plain(*csr, B)
  torch.cuda.synchronize()
  diff = (got.double() - want.double()).abs()
  tol = spmm_tolerance(*csr, B)
  err = float(diff.max()) if diff.numel() else 0.0
  ratio = float((diff / tol.clamp_min(1e-300)).max()) if diff.numel() else 0.0
  same = bool(torch.equal(got, again))
  print(f"  spmm_csr {label}: max|kernel-plain| {err:.3g}, worst share of "
        f"the per-entry bound (spmm_tolerance) {ratio:.3g}; repeat "
        f"bitwise equal: {same}")
  check(got.dtype == torch.promote_types(torch.float32, B.dtype)
        and bool(torch.isfinite(got).all()) and bool((diff <= tol).all()),
        f"spmm_csr disagrees with its plain version on {label}")
  check(same, f"spmm_csr is not deterministic on {label}")
  return err


def ingest_ratings(R):
  """sparse.from_scipy(R, dtype=float32) as ALS's caller does, and the
  route set-up both products need (transpose, block test, CSR forms)."""
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  with Timer() as t_ingest:
    S = sparse.from_scipy(R, dtype=np.float32)
    torch.cuda.synchronize()
  with Timer() as t_route:
    fmts = (sparse.spmm_expr(S, sp.zeros((ML_MOVIES, ALS_K))).fmt,
            sparse.spmm_expr(S.T, sp.zeros((ML_USERS, ALS_K))).fmt)
    torch.cuda.synchronize()
  print(f"  ratings: {S.shape[0]} users x {S.shape[1]} movies, nnz "
        f"{S.nnz} ({S.nnz / ML_RATINGS - 1:+.4%} of {ML_RATINGS}), longest "
        f"user row {S.max_nnz_per_row}, most-rated movie "
        f"{S.T.max_nnz_per_row}, fewest per user "
        f"{int(np.diff(R.indptr).min())}; from_scipy {t_ingest.elapsed:.2f} s, "
        f"route set-up (transpose, block test, CSR forms) "
        f"{t_route.elapsed:.2f} s; padded ELL of R and R.T "
        f"{(S.cols.numel() + S.T.cols.numel()) * 8 / 1e9:.2f} GB; peak device "
        f"memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; SpMMExpr "
        f"fmts {fmts}")
  check(fmts == ("winmm", "winmm"), f"ALS's products took {fmts}, not winmm")
  check(abs(S.nnz - ML_RATINGS) <= 0.01 * ML_RATINGS,
        f"nnz {S.nnz} is not within 1 % of {ML_RATINGS}")
  return S


def phase_spmm_kernel(device, card: str, S):
  """K5a against its plain version on the card, then both ALS products
  timed beside the plain version and cuSPARSE."""
  gen = torch.Generator(device=device).manual_seed(5)
  worst = 0.0
  for label, A in small_cases():
    csr = sparse.from_scipy(A).to_csr()
    m = A.shape[1]
    for k in SPMM_KS:
      B = torch.randn(m, k, generator=gen, device=device)
      worst = max(worst, spmm_check(f"{label} k={k}", csr, B))
    B = torch.randn(m, 64, generator=gen, device=device)
    for dtype in (torch.bfloat16, torch.float16, torch.float64):
      worst = max(worst, spmm_check(f"{label} k=64 {str(dtype)[6:]} B", csr,
                                    B.to(dtype)))
    Bt = torch.randn(64, m, generator=gen, device=device)
    worst = max(worst, spmm_check(f"{label} k=64 B a transposed view", csr,
                                  Bt.t()))
  # rows split into segments of K5.SEG: every k, every type of B
  csr = sparse.from_scipy(skewed_csr()).to_csr()
  label = f"skewed {SKEW_N}x{SKEW_M} (rows of {sorted(SKEW_ROWS.values())})"
  for k in SKEW_KS:
    B = torch.randn(SKEW_M, k, generator=gen, device=device)
    worst = max(worst, spmm_check(f"{label} k={k}", csr, B))
  for dtype in (torch.bfloat16, torch.float16, torch.float64):
    worst = max(worst, spmm_check(f"{label} k=64 {str(dtype)[6:]} B", csr,
                                  B[:, :64].to(dtype)))
  Bt = torch.randn(64, SKEW_M, generator=gen, device=device)
  worst = max(worst, spmm_check(f"{label} k=64 B a transposed view", csr,
                                Bt.t()))
  B = torch.randn(SKEW_M, ALS_K, generator=gen, device=device)
  got, want = K5.spmm_csr(*csr, B), K5.spmm_csr_plain(*csr, B)
  row, segs, share_tail, share_seg = drop_partials(
      csr, B, got, want, spmm_tolerance(*csr, B))
  print(f"  spmm_csr check's power on {label} k={ALS_K}: row {row} "
        f"({segs} segments) without its partials after the first 32 is "
        f"off by {share_tail:.4g}x its bound, without its last segment by "
        f"{share_seg:.4g}x")
  check(segs > 33 and min(share_tail, share_seg) > 1.0,
        f"spmm_csr's check on {label} passes a result that lost partial "
        f"rows")
  del B, Bt, csr, got, want
  products = (("R @ V", S, ML_MOVIES), ("R.T @ U", S.T, ML_USERS))
  total = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
  per_product = {}
  bytes_all = flops_all = 0.0
  for label, A, m in products:
    csr = A.to_csr()
    B = torch.randn(m, ALS_K, generator=gen, device=device)
    worst = max(worst, spmm_check(f"ML-20M {label} k={ALS_K}", csr, B))
    n, nnz = A.shape[0], A.nnz
    lib = torch.sparse_csr_tensor(csr[0].int(), csr[1], csr[2], size=A.shape,
                                  check_invariants=False)
    t = time_in_turns({"plain": lambda: K5.spmm_csr_plain(*csr, B),
                       "kernel": lambda: K5.spmm_csr(*csr, B),
                       "cuSPARSE": lambda: lib @ B}, 3)
    nbytes = nnz * 8 + (n + 1) * 8 + (m + n) * ALS_K * 4
    flops = 2 * nnz * ALS_K
    bound_ms, bound_by = bound(nbytes, flops)
    segments = int(K5.segment_table(csr[0])[-1])
    gathered = nnz * ALS_K * 4  # a row of B a nonzero, from L2
    print(f"  spmm_csr time on ML-20M {label} (n={n}, nnz={nnz}, longest row "
          f"{A.max_nnz_per_row}, {segments} segments of at most {K5.SEG} "
          f"(grid {K5.grid_segments(n, nnz)} warps), gathered rows of B "
          f"{gathered / 1e9:.3f} GB, k={ALS_K}): kernel {t['kernel']:.4f} ms "
          f"({nnz / t['kernel'] / 1e6:.2f} Gnnz/s, "
          f"{flops / t['kernel'] / 1e6:.1f} GFLOP/s, gathers "
          f"{gathered / t['kernel'] / 1e9:.1f} TB/s; "
          f"{t['kernel'] / t['cuSPARSE']:.3f}x cuSPARSE, its work table "
          f"built in the call), plain "
          f"{t['plain']:.4f} ms, cuSPARSE {t['cuSPARSE']:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}, {nbytes / 1e6:.1f} MB, "
          f"{flops / 1e9:.2f} GFLOP) (median of {TIMING_REPS} x 3 calls "
          f"queued ahead of the device, CUDA events, in turns; queued ahead: "
          f"{all(t[f'{v} ahead'] for v in ('kernel', 'plain', 'cuSPARSE'))})"
          f"; host issue per call: kernel {t['kernel host']:.4f} ms, plain "
          f"{t['plain host']:.4f} ms, cuSPARSE {t['cuSPARSE host']:.4f} ms; "
          f"on {card}")
    per_product[label] = t["kernel"]
    for key, name in (("ms", "kernel"), ("plain_ms", "plain"),
                      ("library_ms", "cuSPARSE")):
      total[key] += t[name]
    total["bound_ms"] += bound_ms
    bytes_all += nbytes
    flops_all += flops
    del lib, B
  # the row reports one ALS iteration's two products
  _, total["bound_by"] = bound(bytes_all, flops_all)
  total["max_abs_err"] = worst
  print(f"  spmm_csr both products: kernel {total['ms']:.4f} ms "
        f"({total['ms'] / total['library_ms']:.3f}x cuSPARSE), plain "
        f"{total['plain_ms']:.4f} ms, cuSPARSE {total['library_ms']:.4f} ms, "
        f"bound {total['bound_ms']:.4f} ms; worst |kernel-plain| {worst:.3g}"
        f"; R.T @ U over R @ V (the same nonzeros) "
        f"{per_product['R.T @ U'] / per_product['R @ V']:.3f}x")
  return total


def scipy_als(R, U, V):
  """float64 ALS in numpy/scipy from factors U, V; returns them and the
  largest condition number of the Gram matrices it solved with."""
  R64 = R.astype(np.float64)
  R64t = R64.T.tocsr()
  eye = ALS_REG * np.eye(ALS_K)
  cond = 0.0
  for _ in range(ALS_ITERS):
    gram_v = V.T @ V + eye
    U = np.linalg.solve(gram_v, (R64 @ V).T).T
    gram_u = U.T @ U + eye
    V = np.linalg.solve(gram_u, (R64t @ U).T).T
    cond = max(cond, np.linalg.cond(gram_v), np.linalg.cond(gram_u))
  return U, V, cond


def stored_rmse(S, U, V) -> float:
  """RMSE of U @ V.T over the stored ratings, on the card in float64."""
  indptr, indices, data = S.to_csr()
  rows = torch.repeat_interleave(
      torch.arange(S.shape[0], device=indptr.device), indptr[1:] - indptr[:-1],
      output_size=S.nnz)
  Ut = torch.from_numpy(U).to(indptr.device)
  Vt = torch.from_numpy(V).to(indptr.device)
  sse = 0.0
  for lo in range(0, S.nnz, 1 << 21):
    hi = min(lo + (1 << 21), S.nnz)
    pred = (Ut[rows[lo:hi]] * Vt[indices[lo:hi].long()]).sum(1)
    sse += float(((data[lo:hi].double() - pred) ** 2).sum())
  return (sse / S.nnz) ** 0.5


def device_share(fn, tries: int = 3):
  """(device-busy ms by kernel name, summed device ms, wall ms) of one call
  of ``fn`` under torch.profiler (device events only: kernels and
  copies).  The profiled window reaches 20 ms past the timed call on either
  side, since the profiler drops device events it places outside its window;
  a profile that still holds no device event is taken again, ``tries``
  times in all, and after that the summed device ms is None (not
  measured)."""
  from torch.autograd import DeviceType
  from torch.profiler import ProfilerActivity, profile
  for _ in range(tries):
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
      time.sleep(0.02)
      with Timer() as t_wall:
        fn()
        torch.cuda.synchronize()
      time.sleep(0.02)
    by_name = {}
    for ev in prof.key_averages():
      if ev.device_type == DeviceType.CUDA:
        by_name[ev.key] = ev.self_device_time_total / 1e3
    if by_name:
      return by_name, sum(by_name.values()), t_wall.elapsed * 1e3
  print(f"  torch.profiler recorded no device event in {tries} profiles")
  return {}, None, t_wall.elapsed * 1e3


def phase_als(R, S):
  """als.fit at full width against a float64 scipy ALS; returns K5a's
  launches in that fit, and the factors, the float64 factors and the
  tolerance that phase 14 holds sharded ALS to."""
  torch.cuda.synchronize()
  with Timer() as t_fit:
    U, V = als.fit(S, k=ALS_K, iterations=ALS_ITERS, reg=ALS_REG, seed=0)
  launches, plain_runs = K5.counts["launches"], K5.counts["plain_runs"]
  check(launches == 2 * ALS_ITERS and plain_runs == 0,
        f"ALS launched K5a {launches} times and ran its plain version "
        f"{plain_runs} times; expected {2 * ALS_ITERS} and 0")
  rng = np.random.default_rng(0)
  U0 = rng.standard_normal((ML_USERS, ALS_K)) * 0.1
  V0 = rng.standard_normal((ML_MOVIES, ALS_K)) * 0.1
  with Timer() as t_oracle:
    U64, V64, cond = scipy_als(R, U0, V0)
  err_u = np.abs(U - U64).max() / np.abs(U64).max()
  err_v = np.abs(V - V64).max() / np.abs(V64).max()
  # float32 products within about 2e-5 of their size (sqrt(len)·2^-24 at
  # rows of up to 70 k ratings), amplified by the Gram solves' condition
  # number (first order)
  tol = cond * 2e-5
  rmse, rmse64 = stored_rmse(S, U, V), stored_rmse(S, U64, V64)
  print(f"  als.fit k={ALS_K}, {ALS_ITERS} iterations, reg {ALS_REG}: "
        f"{t_fit.elapsed / ALS_ITERS * 1e3:.1f} ms/iteration (host clock, "
        f"synced, first call included); K5a launches {launches}; max rel "
        f"err vs float64 scipy ALS: U {err_u:.3g}, V {err_v:.3g} (tolerance "
        f"largest Gram condition number {cond:.4g} x 2e-5 = {tol:.3g}); "
        f"RMSE over the stored ratings {rmse:.6f} (float64 ALS "
        f"{rmse64:.6f}); scipy ALS {t_oracle.elapsed:.1f} s")
  check(U.shape == (ML_USERS, ALS_K) and V.shape == (ML_MOVIES, ALS_K)
        and bool(np.isfinite(U).all() and np.isfinite(V).all()),
        "ALS factors are not finite or of the wrong shape")
  check(max(err_u, err_v) <= tol, "ALS disagrees with the float64 ALS")
  with Timer() as t_steady:
    als.fit(S, k=ALS_K, iterations=ALS_ITERS, reg=ALS_REG, seed=0)
  # the pieces of an iteration: a product with its transfers, a host solve
  sv = sp.from_numpy(V)
  np.asarray(sp.dot(S, sv).glom())
  with Timer() as t_product:
    rv = np.asarray(sp.dot(S, sp.from_numpy(V)).glom())
  gram = np.asarray(sp.dot(sv.T, sv).glom()) + ALS_REG * np.eye(ALS_K)
  with Timer() as t_solve:
    np.linalg.solve(gram, rv.T)
  print(f"  an iteration's pieces (host clock): R @ V with V's upload and "
        f"the result's download {t_product.elapsed * 1e3:.1f} ms, the host "
        f"solve for U {t_solve.elapsed * 1e3:.1f} ms")
  by_name, busy, wall = device_share(
      lambda: als.fit(S, k=ALS_K, iterations=1, reg=ALS_REG, seed=0))
  top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
  share = ("device busy not measured" if busy is None else
           f"device busy {busy:.2f} ms (idle share {1 - busy / wall:.3f})")
  print(f"  als.fit steady {t_steady.elapsed / ALS_ITERS * 1e3:.1f} "
        f"ms/iteration (host clock, synced); one iteration under "
        f"torch.profiler: wall {wall:.1f} ms, {share}; by kernel (ms): "
        + ", ".join(f"{name[:48]} {ms:.3f}" for name, ms in top))
  return launches, (U, V, U64, V64, tol)


# -- stencils, heat, Jacobi-Poisson, convnet -----------------------------------

# unit roundoff of the kernels' types (2^-p, p the significand's bits)
UNIT = {torch.float32: 2.0 ** -24, torch.bfloat16: 2.0 ** -8,
        torch.float16: 2.0 ** -11}


def stencil_tol(dtype, coeffs, steps, x_max, add_max=0.0) -> float:
  """0 in float32: kernel and plain version round the same ops in the same
  order.  In bfloat16/float16 the bound of two roundings apart per op: per
  step 2·(taps + 1)·u of the largest Σ|c·x| + |add| it reaches, grown by
  the gain Σ|c| of each later step."""
  if dtype == torch.float32:
    return 0.0
  gain = sum(abs(c) for c in coeffs)
  taps = sum(c != 0.0 for c in coeffs)
  scale, worst = x_max, 0.0
  for _ in range(steps):
    scale = gain * scale + add_max
    worst = max(worst, scale)
  return (2 * (taps + 1) * UNIT[dtype] * steps * worst
          * max(gain, 1.0) ** (steps - 1))


def ring(xp: torch.Tensor) -> torch.Tensor:
  """The pad ring of a padded array, flattened."""
  mask = torch.ones(xp.shape, dtype=torch.bool, device=xp.device)
  mask[K6.PAD_R:-K6.PAD_R, K6.PAD_C:-K6.PAD_C] = False
  return xp[mask]


def phase_stencil_kernels(device, card: str):
  """K4 and K6a against their plain versions on the card, then timed at
  16384^2 float32 beside their plain versions and cuDNN."""
  gen = torch.Generator(device=device).manual_seed(17)
  worst = {"stencil3x3": 0.0, "stencil3x3_padded": 0.0}
  n_cases = {"stencil3x3": 0, "stencil3x3_padded": 0}
  for shape in STENCIL_SHAPES:
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
      bitwise = {"stencil3x3": True, "stencil3x3_padded": True}
      ratio = {"stencil3x3": 0.0, "stencil3x3_padded": 0.0}
      for coeffs in (LAPLACIAN, NINE):
        x = torch.randn(shape, generator=gen, device=device).to(dtype)
        g = torch.randn(shape, generator=gen, device=device).to(dtype)
        x_max = float(x.abs().max())
        cases = [("stencil3x3", K6.stencil3x3(x, coeffs),
                  K6.stencil3x3_plain(x, coeffs),
                  stencil_tol(dtype, coeffs, 1, x_max))]
        xp, gp = K6.to_padded(x), K6.to_padded(g)
        for add in (None, gp):
          add_max = float(g.abs().max()) if add is not None else 0.0
          for steps in (1, 2, 3):
            # a NaN ring on buf shows the kernel never writes it; after
            # one step buf holds the result, so its ring must stay NaN
            buf = torch.full_like(xp, float("nan")) if steps == 1 else (
                torch.zeros_like(xp))
            got, _ = K6.stencil3x3_padded(xp.clone(), buf, coeffs, steps,
                                          add)
            want, _ = K6.stencil3x3_padded_plain(
                xp.clone(), buf.clone(), coeffs, steps, add)
            check(bool(ring(got).isnan().all()) if steps == 1 else
                  not bool(ring(got).any()),
                  f"K6a wrote the ring of its output ({shape}, {steps})")
            cases.append(("stencil3x3_padded", K6.from_padded(got),
                          K6.from_padded(want),
                          stencil_tol(dtype, coeffs, steps, x_max, add_max)))
        for name, got, want, tol in cases:
          torch.cuda.synchronize()
          diff = (got.double() - want.double()).abs()
          err = float(diff.max())
          check(got.dtype == dtype and got.shape == want.shape
                and bool(torch.isfinite(got).all()) and err <= tol,
                f"{name} disagrees with its plain version on {shape} "
                f"{dtype}: max|diff| {err:.3g} > {tol:.3g}")
          worst[name] = max(worst[name], err)
          bitwise[name] = bitwise[name] and bool(torch.equal(got, want))
          ratio[name] = max(ratio[name], err / tol if tol else 0.0)
          n_cases[name] += 1
      for name in ("stencil3x3", "stencil3x3_padded"):
        rule = ("bit for bit" if dtype == torch.float32 else
                f"worst share of the bound 2(taps+1)u per step {ratio[name]:.3g}")
        print(f"  {name:17s} {str(shape):13s} {str(dtype)[6:]:8s} laplacian "
              f"and nine taps{', add and no add, steps 1-3' if 'padded' in name else ''}: "
              f"equal to the plain version {rule}; bitwise equal: "
              f"{bitwise[name]}")
      check(dtype != torch.float32 or all(bitwise.values()),
            f"a stencil kernel is not bit-equal to its plain version in "
            f"float32 on {shape}")
  launches = dict(K6.counts)
  print(f"  cases: {n_cases}; counts {launches}")
  check(launches["k4_launches"] == n_cases["stencil3x3"]
        and launches["k6a_launches"] == 2 * 2 * 6 * len(STENCIL_SHAPES) * 3
        and launches["plain_runs"] == launches["routed_plain"] == 0,
        f"unexpected stencil counts {launches}")
  x64 = torch.randn(13, 20, device=device, dtype=torch.float64)
  K6.stencil3x3(x64, NINE)
  check(K6.counts["routed_plain"] == 1 and K6.counts["k4_launches"]
        == launches["k4_launches"], "float64 did not take the plain route")

  # time at 16384^2 float32: the heat and Jacobi coefficients (K6a's main
  # path), the Laplacian for K4; cuDNN's F.conv2d with TF32 off as the
  # library call (plus the add for K6a's add form)
  torch.backends.cudnn.allow_tf32 = False
  n = GRID_N
  x = torch.rand((n, n), generator=gen, device=device)
  g = torch.randn((n, n), generator=gen, device=device)
  xp, gp, buf = K6.to_padded(x), K6.to_padded(g), torch.zeros(
      K6.padded_shape(n, n), device=device)
  x4, g4 = x[None, None], g[None, None]

  def weights(coeffs):
    return torch.tensor(coeffs, device=device).view(1, 1, 3, 3)

  w_lap, w_heat, w_jac = weights(LAPLACIAN), weights(HEAT), weights(JACOBI)
  timed = {
      "stencil3x3": ("Laplacian", 2, {
          "plain": lambda: K6.stencil3x3_plain(x, LAPLACIAN),
          "kernel": lambda: K6.stencil3x3(x, LAPLACIAN),
          "cuDNN": lambda: F.conv2d(x4, w_lap, padding=1)}),
      "padded": ("heat", 2, {
          "plain": lambda: K6.stencil3x3_padded_plain(xp, buf, HEAT),
          "kernel": lambda: K6.stencil3x3_padded(xp, buf, HEAT),
          "cuDNN": lambda: F.conv2d(x4, w_heat, padding=1)}),
      "padded add": ("Jacobi", 3, {
          "plain": lambda: K6.stencil3x3_padded_plain(xp, buf, JACOBI,
                                                      add=gp),
          "kernel": lambda: K6.stencil3x3_padded(xp, buf, JACOBI, add=gp),
          "cuDNN": lambda: F.conv2d(x4, w_jac, padding=1).add_(g4)}),
  }
  rows = {}
  for label, (cname, fields, fns) in timed.items():
    t = time_in_turns(fns)
    coeffs = {"Laplacian": LAPLACIAN, "heat": HEAT, "Jacobi": JACOBI}[cname]
    nbytes = fields * n * n * 4
    flops = 2 * sum(c != 0.0 for c in coeffs) * n * n
    bound_ms, bound_by = bound(nbytes, flops)
    print(f"  {label} ({cname} taps) at {n}^2 float32: kernel "
          f"{t['kernel']:.4f} ms ({nbytes / t['kernel'] / 1e6:.1f} GB/s), "
          f"plain {t['plain']:.4f} ms, cuDNN conv2d"
          f"{' + add' if fields == 3 else ''} {t['cuDNN']:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}, {nbytes / 1e9:.3f} GB) (median of "
          f"{TIMING_REPS}, queued ahead of the device: "
          f"{all(t[f'{v} ahead'] for v in ('kernel', 'plain', 'cuDNN'))}, "
          f"CUDA events, in turns); host issue per call: kernel "
          f"{t['kernel host']:.4f} ms; on {card}")
    rows[label] = {"ms": t["kernel"], "plain_ms": t["plain"],
                   "library_ms": t["cuDNN"], "bound_ms": bound_ms,
                   "bound_by": bound_by, "bytes": nbytes, "flops": flops}
  k4 = dict(rows["stencil3x3"], max_abs_err=worst["stencil3x3"],
            launches=launches["k4_launches"])
  # K6a's row: one heat sweep plus one Jacobi sweep, its two forms on the
  # path
  k6a = {key: rows["padded"][key] + rows["padded add"][key]
         for key in ("ms", "plain_ms", "library_ms", "bound_ms", "bytes",
                     "flops")}
  k6a.update(bound_by=bound(k6a["bytes"], k6a["flops"])[1],
             max_abs_err=worst["stencil3x3_padded"])
  return k4, k6a


def heat_oracle(u0: torch.Tensor, iters: int, alpha: float):
  """simulate_numpy's iteration in float64 torch on the card."""
  u = u0.double()
  for _ in range(iters):
    up = F.pad(u, (1, 1, 1, 1))
    u = u + alpha * (up[:-2, 1:-1] + up[2:, 1:-1] + up[1:-1, :-2]
                     + up[1:-1, 2:] - 4.0 * u)
  return u


def jacobi_oracle(f: torch.Tensor, iters: int, h: float = 1.0):
  """solve_jacobi_numpy's iteration in float64 torch on the card; returns
  u and the sum over sweeps of max|u| + max|h^2 f / 4|."""
  f = f.double()
  u = torch.zeros_like(f)
  g_max = float((h * h / 4.0) * f.abs().max())
  scale = 0.0
  for _ in range(iters):
    up = F.pad(u, (1, 1, 1, 1))
    u = (up[:-2, 1:-1] + up[2:, 1:-1] + up[1:-1, :-2] + up[1:-1, 2:]
         ) / 4.0 - (h * h / 4.0) * f
    scale += float(u.abs().max()) + g_max
  return u, scale


def conv_numpy(x: np.ndarray, w: np.ndarray) -> np.ndarray:
  """'SAME' 3x3 stride-1 cross-correlation, NCHW by OIHW, in float64."""
  _, _, h, wd = x.shape
  xp = np.pad(x, ((0, 0), (0, 0), (1, 1), (1, 1)))
  return sum(np.einsum("nchw,oc->nohw", xp[:, :, di:di + h, dj:dj + wd],
                       w[:, :, di, dj])
             for di in range(3) for dj in range(3))


def convnet_numpy(images: np.ndarray, params) -> np.ndarray:
  def pool(v):
    n, c, h, w = v.shape
    return v.reshape(n, c, h // 2, 2, w // 2, 2).max(axis=(3, 5))
  h1 = pool(np.maximum(conv_numpy(images, params["w1"]), 0.0))
  h2 = pool(np.maximum(conv_numpy(h1, params["w2"]), 0.0))
  return h2.reshape(len(h2), -1) @ params["wd"] + params["bd"]


def padded_sweeps(label, run, oracle, device):
  """Run the entry point ``run`` (returns numpy) and hold it against
  ``oracle`` (returns the float64 field and the tolerance)."""
  before = K6.counts["k6a_launches"]
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  held = torch.cuda.memory_allocated()
  with Timer() as t_run:
    got = run()
  peak = torch.cuda.max_memory_allocated() - held
  launches = K6.counts["k6a_launches"] - before
  with Timer() as t_oracle:
    want, tol = oracle()
  got_t = torch.from_numpy(got).to(device)
  err = float((got_t.double() - want).abs().max())
  n = GRID_N
  print(f"  {label} {n}^2 float32, {SWEEPS} sweeps: K6a launches {launches}; "
        f"max|u - u64| {err:.4g} (tolerance {tol:.4g}); entry point wall "
        f"{t_run.elapsed:.3f} s ({t_run.elapsed / SWEEPS * 1e3:.4f} ms a "
        f"sweep with set-up and the result's copy to the host, host clock, "
        f"synced); peak device memory {peak / 1e9:.2f} GB above the "
        f"{held / 1e9:.2f} GB held before; float64 oracle on the card "
        f"{t_oracle.elapsed:.2f} s")
  check(got.shape == (n, n) and got.dtype == np.float32
        and bool(torch.isfinite(got_t).all()), f"{label}: bad field")
  check(launches == SWEEPS, f"{label}: K6a launched {launches} times, "
        f"expected {SWEEPS}")
  check(err <= tol, f"{label} disagrees with its float64 oracle")
  del got_t, want
  return got


def sweep_profile(label, coeffs, fields, state, add, card: str):
  """Device time and idle share of one chunk of CHUNK sweeps through the
  wrapper, under torch.profiler; K6a's time by CUDA events where the
  profiler recorded no device event."""
  xp = K6.to_padded(state)
  buf = torch.zeros_like(xp)

  def chunk():
    K6.stencil3x3_padded(xp, buf, coeffs, CHUNK, add)

  chunk()  # warm
  by_name, busy, wall = device_share(chunk)
  nbytes = fields * GRID_N * GRID_N * 4
  if busy is None:
    kernel_ms = event_ms(chunk)[0] / CHUNK
    share = (f"device busy and idle share not measured; K6a {kernel_ms:.4f} "
             f"ms a sweep by CUDA events")
  else:
    kernel_ms = sum(ms for name, ms in by_name.items()
                    if "stencil3x3" in name) / CHUNK
    check(kernel_ms > 0, f"{label}: the profile shows no K6a device time "
          f"({sorted(by_name)})")
    share = (f"device busy {busy:.3f} ms (idle share {1 - busy / wall:.3f}); "
             f"K6a {kernel_ms:.4f} ms a sweep")
  print(f"  {label}: one chunk of {CHUNK} sweeps under torch.profiler: wall "
        f"{wall:.3f} ms, {share}, {nbytes / kernel_ms / 1e6:.1f} GB/s "
        f"effective ({fields} x n^2 x 4 bytes); on {card}")


def phase_stencil_path(device, card: str):
  """heat.simulate_padded and poisson.solve_jacobi at 16384^2 float32,
  heat.simulate at 4096^2 float64, convnet at MNIST's test-set shape;
  returns K6a's launches on the padded path, and the heat sweeps' initial
  field (on the card) and result (numpy) for phase 14."""
  gen = torch.Generator(device=device).manual_seed(23)
  n = GRID_N
  u0 = torch.rand((n, n), generator=gen, device=device)
  f = torch.randn((n, n), generator=gen, device=device)
  K6.reset_counts()  # count the padded path's launches only
  # heat: gain 1 (non-negative coefficients summing to 1 for alpha <=
  # 0.25), so max|u| never exceeds max|u0| and each sweep adds at most
  # 2(taps + 1) roundings of 2^-24 max|u0| (the float32 coefficients'
  # own rounding among them)
  heat_result = padded_sweeps(
      "heat.simulate_padded",
      lambda: heat.simulate_padded(u0, iters=SWEEPS, alpha=HEAT_ALPHA),
      lambda: (heat_oracle(u0, SWEEPS, HEAT_ALPHA),
               SWEEPS * 2 * 6 * 2.0 ** -24 * float(u0.abs().max())),
      device)

  # Jacobi: gain 1, so the sweeps' roundings add up: per sweep 2(taps + 1)
  # 2^-24 of max|u| + max|h^2 f/4| (0.25 and the field -f/4 are exact)
  def jacobi():
    u, scale = jacobi_oracle(f, SWEEPS)
    return u, 2 * 5 * 2.0 ** -24 * scale

  padded_sweeps("poisson.solve_jacobi",
                lambda: poisson.solve_jacobi(f, iters=SWEEPS), jacobi, device)
  launches = K6.counts["k6a_launches"]
  check(launches >= 2 * SWEEPS and K6.counts["plain_runs"] == 0
        and K6.counts["routed_plain"] == 0,
        f"the padded path launched K6a {launches} times (counts {K6.counts})")
  sweep_profile("heat", HEAT, 2, u0, None, card)
  sweep_profile("Jacobi", JACOBI, 3, torch.zeros_like(f),
                K6.to_padded(-0.25 * f), card)
  del f

  # the expression path: make_fori over StencilExpr and ReshapeExpr
  rng = np.random.default_rng(29)
  v0 = rng.random((EXPR_N, EXPR_N))
  torch.cuda.synchronize()
  with Timer() as t_expr:
    got = heat.simulate(v0, iters=EXPR_STEPS, alpha=HEAT_ALPHA).glom()
  with Timer() as t_np:
    want = heat.simulate_numpy(v0, iters=EXPR_STEPS, alpha=HEAT_ALPHA)
  err = float(np.abs(got - want).max())
  print(f"  heat.simulate {EXPR_N}^2 float64, {EXPR_STEPS} steps: max|diff| "
        f"vs simulate_numpy {err:.3g} (tolerance 1e-10 max|u|); "
        f"{t_expr.elapsed:.2f} s with the copies (host clock), numpy "
        f"{t_np.elapsed:.2f} s")
  check(got.dtype == np.float64 and got.shape == (EXPR_N, EXPR_N)
        and err <= 1e-10 * np.abs(want).max(),
        "heat.simulate disagrees with simulate_numpy")

  # convnet's forward pass on MNIST's test-set shape (synthetic images)
  images = rng.random(MNIST_SHAPE)
  params = convnet.init_params()
  torch.cuda.synchronize()
  with Timer() as t_fwd:
    logits = convnet.forward(sp.from_numpy(images), params).glom()
  pred = convnet.predict(sp.from_numpy(images), params).glom()
  want = convnet_numpy(images[:CONV_CHECK], params)
  err = float(np.abs(logits[:CONV_CHECK] - want).max())
  print(f"  convnet.forward {MNIST_SHAPE} float64: {t_fwd.elapsed:.3f} s "
        f"with the copies (host clock); max|logits - numpy| on the first "
        f"{CONV_CHECK} {err:.3g} (tolerance 1e-10 max|logits|); predict "
        f"equals argmax(forward) on all {MNIST_SHAPE[0]}")
  check(logits.shape == (MNIST_SHAPE[0], 10) and logits.dtype == np.float64
        and bool(np.isfinite(logits).all())
        and err <= 1e-10 * np.abs(want).max(),
        "convnet.forward disagrees with the numpy forward")
  check(np.array_equal(pred, logits.argmax(axis=1))
        and np.array_equal(pred[:CONV_CHECK], want.argmax(axis=1)),
        "convnet.predict disagrees with argmax(forward)")
  return launches, (u0, heat_result)


# -- the matrix product K2 -------------------------------------------------------

OUT_UNIT = {torch.float32: 0.0, torch.bfloat16: 2.0 ** -8,
            torch.float16: 2.0 ** -11}


def relu(acc):
  return torch.clamp_min(acc, 0.0)


def matmul_tol(x, y, want, absprod=None, sqprod=None):
  """Both sides sum the same K exact products in float32 in another order:
  worst case d <= 2·K·2^-24·(|x| @ |y|), doubled because tensor cores may
  truncate inside their adds, or the random-walk bound on x² @ y²,
  whichever is smaller; a 16-bit output rounds each side once more,
  2u·(|want| + d) on top."""
  xf, yf = x.float(), y.float()
  if absprod is None:
    absprod = xf.abs() @ yf.abs()
  if sqprod is None:
    sqprod = xf.square() @ yf.square()
  d = sum_bound(x.shape[1], absprod, sqprod, 4.0)
  return d + 2.0 * OUT_UNIT[x.dtype] * (want.float().abs() + d)


def phase_matmul_kernel(device):
  """K2 against matmul_plain on the card: four shapes, three dtypes, with
  and without the ReLU epilogue (fused), and one epilogue outside the op
  table (unfused); returns the worst |kernel - plain|."""
  check_ptxas("matmul", "hopper_gemm", "K2")
  check_ptxas("matmul", "sgemm", "K2 float32")
  print(f"  K2 16-bit kernel: {K2.TILE_M} x {K2.TILE_N} output tiles, "
        f"{K2.TILE_K}-deep stages, a ring of {K2.STAGES}; float32: "
        f"{K2.SGEMM_TILE_M} x {K2.SGEMM_TILE_N} output tiles, "
        f"{K2.SGEMM_TILE_K}-deep stages, a ring of {K2.SGEMM_STAGES}")
  gen = torch.Generator(device=device).manual_seed(41)
  worst, cases = 0.0, 0
  for m, k, n in MATMUL_SHAPES:
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
      x = torch.randn(m, k, generator=gen, device=device).to(dtype)
      y = torch.randn(k, n, generator=gen, device=device).to(dtype)
      for label, epilogue in (("none", None), ("relu", relu)):
        before = dict(K2.counts)
        got = K2.matmul(x, y, epilogue=epilogue)
        again = K2.matmul(x, y, epilogue=epilogue)
        want = K2.matmul_plain(x, y, epilogue)
        torch.cuda.synchronize()
        # an operand whose rows are not a multiple of 16 bytes is padded
        # first, once a call (TMA reads both in every dtype)
        per16 = 16 // x.element_size()
        padded = 2 * ((k % per16 != 0) + (n % per16 != 0))
        check(K2.counts == dict(before, launches=before["launches"] + 2,
                                padded_operands=before["padded_operands"]
                                + padded),
              f"K2 counts {K2.counts} after {before}: the {label} epilogue "
              f"did not fuse into two launches with {padded} padded operands")
        diff = (got.float() - want.float()).abs()
        tol = matmul_tol(x, y, want)
        share = float((diff / tol.clamp_min(1e-30)).max())
        err = float(diff.max())
        worst = max(worst, err)
        cases += 1
        same = bool(torch.equal(got, again))
        print(f"  K2 {m}x{k}x{n} {str(dtype)[6:]:8s} epilogue {label}: "
              f"max|kernel-plain| {err:.3g}, worst share of the bound "
              f"{share:.3g}; repeat bitwise equal: {same}")
        check(got.dtype == dtype and got.shape == (m, n)
              and bool(torch.isfinite(got).all()) and bool((diff <= tol).all()),
              f"K2 disagrees with its plain version: {m}x{k}x{n} {dtype} "
              f"{label}")
        check(same, f"K2 is not deterministic: {m}x{k}x{n} {dtype} {label}")
  x = torch.randn(300, 500, generator=gen, device=device)
  y = torch.randn(500, 200, generator=gen, device=device)
  before = dict(K2.counts)
  got = K2.matmul(x, y, epilogue=torch.sigmoid)
  want = K2.matmul_plain(x, y, torch.sigmoid)
  torch.cuda.synchronize()
  check(K2.counts == dict(before, launches=before["launches"] + 1,
                          epilogue_unfused=before["epilogue_unfused"] + 1),
        f"the sigmoid epilogue was not run unfused after one launch "
        f"({K2.counts})")
  err = float((got - want).abs().max())
  check(bool(((got - want).abs() <= matmul_tol(x, y, want)).all()),
        "K2 with an unfused epilogue disagrees with its plain version")
  worst = max(worst, err)
  print(f"  K2 300x500x200 float32 epilogue sigmoid (outside the op table, "
        f"run in torch on the kernel's float32 product): max|kernel-plain| "
        f"{err:.3g}; {cases + 1} cases, counts {K2.counts}")
  return max(worst, check_new_epilogues(device))


def mod2(acc):
  return acc % 2.0


def abs_pow(acc):
  return torch.abs(acc) ** 1.5


def check_new_epilogues(device):
  """K2's epilogue with % and ** (op-program instructions since the op
  table took them) against matmul_plain at 300x191x520: the product's
  bound carried through the op (for %, the distance on the circle of the
  modulus; for |a|**1.5, its derivative 1.5·|a|**0.5 times the bound, and
  4 ulps of the result); in float32 also against torch's op on the
  kernel's own product, bit for bit for % and at 2 float32 ulps for
  ** (powf on both sides).  Returns the worst |kernel - plain|."""
  gen = torch.Generator(device=device).manual_seed(47)
  worst = 0.0
  for dtype in (torch.float32, torch.bfloat16):
    x = torch.randn(300, 191, generator=gen, device=device).to(dtype)
    y = torch.randn(191, 520, generator=gen, device=device).to(dtype)
    before = dict(K2.counts)
    got = {"%": K2.matmul(x, y, epilogue=mod2),
           "**": K2.matmul(x, y, epilogue=abs_pow)}
    check(K2.counts == dict(before, launches=before["launches"] + 2,
                            padded_operands=before["padded_operands"] + 2),
          f"the % and ** epilogues did not fuse into two launches "
          f"({K2.counts})")
    prod = K2.matmul_plain(x, y)
    tol = matmul_tol(x, y, prod).float()
    unit = max(OUT_UNIT[dtype], 2.0 ** -23)
    want = {"%": K2.matmul_plain(x, y, mod2),
            "**": K2.matmul_plain(x, y, abs_pow)}
    d = (got["%"].float() - want["%"].float()).abs()
    d_mod = torch.minimum(d, 2.0 - d)
    ok_mod = bool((d_mod <= tol + 4.0 * unit).all())
    base = prod.float().abs()
    pow_tol = (1.5 * (base + tol).sqrt() * tol
               + 4.0 * unit * want["**"].float().abs())
    d_pow = (got["**"].float() - want["**"].float()).abs()
    ok_pow = bool((d_pow <= pow_tol).all())
    worst = max(worst, float(d_mod.max()), float(d_pow.max()))
    own = ""
    if dtype == torch.float32:
      mine = K2.matmul(x, y)
      same_mod = bool(torch.equal(got["%"], torch.remainder(mine, 2.0)))
      pow_ulps = float(((got["**"] - torch.abs(mine) ** 1.5).abs()
                        / (torch.abs(mine) ** 1.5).clamp_min(1e-30)).max()
                       / 2.0 ** -23)
      own = (f"; on the kernel's own product: % bit-equal {same_mod}, ** "
             f"within {pow_ulps:.2f} ulps")
      check(same_mod and pow_ulps <= 2.0,
            "K2's % or ** epilogue disagrees with torch on its own product")
    print(f"  K2 300x191x520 {str(dtype)[6:]} epilogues a % 2.0 and "
          f"|a| ** 1.5 (fused): max circular |kernel-plain| "
          f"{float(d_mod.max()):.3g}, max |kernel-plain| for ** "
          f"{float(d_pow.max()):.3g}, within the bound: {ok_mod and ok_pow}"
          f"{own}")
    check(ok_mod and ok_pow,
          f"K2's % or ** epilogue disagrees with matmul_plain ({dtype})")
  return worst


def check_product(x, y, got, want, label: str, block: int = 4096):
  """Holds a full-size K2 product against its reference, ``block`` rows at
  a time, and shows the check's power: the first block without one of the
  kernel's K tiles (SGEMM_TILE_K wide in float32, TILE_K in 16-bit) must
  fail it.
  Returns max|got - want|, the worst share of the bound, the tile and the
  share of that block's entries the check rejects without it."""
  n, dtype = x.shape[1], x.dtype
  ya, y2 = y.float().abs(), y.float().square()
  err, share = 0.0, 0.0
  tile = K2.SGEMM_TILE_K if dtype == torch.float32 else K2.TILE_K
  caught = 0.0
  for lo in range(0, x.shape[0], block):
    xb = x[lo:lo + block].float()
    tol = matmul_tol(x[lo:lo + block], y, want[lo:lo + block],
                     xb.abs() @ ya, xb.square() @ y2)
    d = (got[lo:lo + block].float() - want[lo:lo + block].float()).abs()
    check(bool((d <= tol).all()) and bool(torch.isfinite(got[lo:lo + block])
                                          .all()),
          f"K2 disagrees with {label}: worst share of the bound "
          f"{float((d / tol.clamp_min(1e-30)).max()):.4g}")
    err = max(err, float(d.max()))
    share = max(share, float((d / tol.clamp_min(1e-30)).max()))
    if lo == 0:
      k0 = n // 2 // tile * tile
      bad = (got[:block].float() - xb[:, k0:k0 + tile]
             @ y[k0:k0 + tile].float()).to(dtype).float()
      caught = float(((bad - want[:block].float()).abs() > tol).float()
                     .mean())
      check(caught > 0.5, f"K2's check against {label} passes a product "
            f"that lost one K tile")
      del bad
    del xb, d, tol
  return err, share, tile, caught


def phase_matmul_path(device, card: str):
  """matmul.matmul at config 2's published 32768^2 float32 against
  torch.matmul (TF32 off), and at bench.py's 8192^2 bfloat16 against
  matmul_plain; each timed beside matmul_plain and cuBLAS.  Returns the
  32768^2 row of the kernels line."""
  check(not torch.backends.cuda.matmul.allow_tf32,
        "TF32 is on: the float32 yardstick would not be full float32")
  gen = torch.Generator(device=device).manual_seed(43)
  rows = {}
  block = 4096
  for n, dtype, peak, reps in ((CFG2_N, torch.float32, F32_FLOPS, CFG2_REPS),
                               (BENCH_MM_N, torch.bfloat16, BF16_FLOPS,
                                TIMING_REPS)):
    x = torch.randn(n, n, generator=gen, device=device).to(dtype)
    y = torch.randn(n, n, generator=gen, device=device).to(dtype)
    torch.cuda.synchronize()
    with Timer() as t_call:
      got = K2.matmul(x, y)
      torch.cuda.synchronize()
    ref_name = "torch.matmul" if dtype == torch.float32 else "matmul_plain"
    want = torch.matmul(x, y) if dtype == torch.float32 else K2.matmul_plain(
        x, y)
    err, share, tile, caught = check_product(
        x, y, got, want, f"{ref_name} at {n}^2 {dtype}", block)
    del want
    same = bool(torch.equal(got, K2.matmul(x, y)))
    check(same, f"K2 at {n}^2 {dtype} is not bit-equal on repeat")
    del got
    fns = {"plain": lambda: K2.matmul_plain(x, y),
           "kernel": lambda: K2.matmul(x, y),
           "cuBLAS": lambda: torch.matmul(x, y)}
    t = time_in_turns(fns, reps=reps)
    flops = 2.0 * n ** 3
    nbytes = 3.0 * n * n * x.element_size()
    bound_ms, bound_by = bound(nbytes, flops, peak)
    print(f"  K2 {n}^2 {str(dtype)[6:]}: one call {t_call.elapsed:.3f} s "
          f"(host clock, first at this shape); max|kernel - {ref_name}| "
          f"{err:.4g}, worst share of the bound {share:.3g} (a result "
          f"without one {tile}-wide K tile fails it at {100 * caught:.1f}% "
          f"of the first {block} rows' entries); repeat bitwise equal: "
          f"{same}; kernel "
          f"{t['kernel']:.4f} ms ({flops / t['kernel'] / 1e9:.1f} TFLOP/s), "
          f"matmul_plain {t['plain']:.4f} ms, cuBLAS torch.matmul "
          f"{t['cuBLAS']:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}) "
          f"(median of {reps}, CUDA events, in turns; queued ahead: "
          f"{all(t[f'{v} ahead'] for v in ('kernel', 'plain', 'cuBLAS'))}) "
          f"on {card}")
    print(f"  K2 {n}^2 {str(dtype)[6:]}: "
          f"{100 * flops / (t['kernel'] * 1e-3) / peak:.1f} % of "
          f"{peak / 1e12:.0f} TFLOP/s; kernel / cuBLAS "
          f"{t['kernel'] / t['cuBLAS']:.3f} on {card}")
    rows[(n, dtype)] = {"ms": t["kernel"], "plain_ms": t["plain"],
                        "library_ms": t["cuBLAS"], "bound_ms": bound_ms,
                        "bound_by": bound_by, "max_abs_err": err}
    del x, y
    torch.cuda.empty_cache()
  return rows


# -- the unique-rows SpMV K3c and make_spmv_windowed ---------------------------

def chunk_cases():
  """K3c's edge cases: no nonzero, fewer than one chunk, chunk boundaries
  on row boundaries, empty rows at both ends, rows longer than 10 chunks,
  runs of empty rows inside chunks, tests/test_kernels.py's heavy-duplicate
  row and its duplicate-summed random matrix."""
  rng = np.random.default_rng(13)
  cases = [("nnz 0", ss.csr_matrix((50, 40), dtype=np.float32)),
           ("below one chunk", ss.random(40, 50, density=0.15, random_state=1,
                                         format="csr", dtype=np.float32))]
  lengths = np.array([512, 512, 1024, 256, 768, 1024, 3])
  indptr = np.concatenate([[0], np.cumsum(lengths)])
  cases.append(("rows on chunk boundaries", ss.csr_matrix(
      (rng.standard_normal(indptr[-1]).astype(np.float32),
       rng.integers(0, 3000, indptr[-1]).astype(np.int32), indptr),
      shape=(len(lengths), 3000))))
  ends = ss.random(300, 700, density=0.05, random_state=2, format="lil",
                   dtype=np.float32)
  ends[:100, :] = 0
  ends[200:, :] = 0
  cases.append(("empty rows at both ends", ends.tocsr()))
  long_rows = ss.random(64, 20000, density=0.001, random_state=3, format="lil",
                        dtype=np.float32)
  for row, count in ((7, 12_000), (8, 15_000)):
    long_rows[row, rng.choice(20000, count, replace=False)] = (
        rng.standard_normal(count).astype(np.float32))
  cases.append(("rows of 12000 and 15000", long_rows.tocsr()))
  cases.append(("empty-row runs in chunks", ss.random(
      200_000, 500, density=2e-5, random_state=4, format="csr",
      dtype=np.float32)))
  dup = ss.lil_matrix((1100, 1100), dtype=np.float32)
  dup[5, 0:200] = rng.standard_normal(200)
  dup[5, 1024:1060] = rng.standard_normal(36)
  cases.append(("heavy duplicates", dup.tocsr()))
  n, m = 3000, 2500
  r, c = rng.integers(0, n, n * 9), rng.integers(0, m, n * 9)
  A = ss.coo_matrix((rng.standard_normal(n * 9).astype(np.float32), (r, c)),
                    shape=(n, m)).tocsr()
  A.sum_duplicates()
  cases.append(("random, duplicates summed", A))
  return cases


def row_tol(indptr, indices, data, x, want):
  """Per row of a CSR matrix the smaller of 2·len·2^-24·Σ|a·x| (float32
  sums of the same products in another order) and the random-walk bound on
  Σ(a·x)², plus one rounding to x's dtype on each side."""
  lengths = (indptr[1:] - indptr[:-1]).float()
  sum_abs = KS.spmv_csr_plain(indptr, indices, data.abs(), x.float().abs())
  sum_sq = KS.spmv_csr_plain(indptr, indices, data.square(),
                             x.float().square())
  return (sum_bound(lengths, sum_abs, sum_sq, 2.0)
          + 2.0 * OUT_UNIT[x.dtype] * want.float().abs())


def drop_chunk_head(packed, x, got, want, tol):
  """The check's power on K3c: ``got`` less one part of a row that the
  kernel adds in a pass of its own.  On a windowed pack, one window's
  partial of the longest row (the window holding most of its products);
  else one chunk's head, the products of the chunk's first row that the
  chunk carries into that row, for the longest row where it crosses a
  chunk boundary, else for the middle chunk.  Returns the row, the part
  dropped, the products in it, |error| and the row's bound."""
  r = int((packed.indptr[1:] - packed.indptr[:-1]).argmax())
  if packed.windows is not None:
    w = packed.windows
    starts, ends = w.indptr[:, r].tolist(), w.indptr[:, r + 1].tolist()
    s = max(range(w.count), key=lambda k: ends[k] - starts[k])
    lo, hi = starts[s], ends[s]
    part = float((w.data[lo:hi].double() * x[
        s * KS.WINDOW + w.indices[lo:hi].long()].double()).sum())
    return (r, f"window {s}'s partial", hi - lo,
            abs(float(got[r]) - part - float(want[r])), float(tol[r]))
  s, e = int(packed.indptr[r]), int(packed.indptr[r + 1])
  j = s // KS.CHUNK + 1
  if j * KS.CHUNK >= e:
    j = packed.chunk_row.shape[0] // 2
    r = int(packed.chunk_row[j])
    e = int(packed.indptr[r + 1])
  lo, hi = j * KS.CHUNK, min(e, (j + 1) * KS.CHUNK)
  head = float((packed.data[lo:hi].double()
                * x[packed.indices[lo:hi].long()].double()).sum())
  return (r, f"chunk {j}'s head", hi - lo,
          abs(float(got[r]) - head - float(want[r])), float(tol[r]))


def check_spmv_full(packed, x, label: str):
  """K3c on a full-size pack (in the form the pack holds) against its plain
  version and itself (bit for bit), and the check's power: the result
  without one window's partial (windowed) or one chunk's head
  (unwindowed) must fail it.  Returns max|kernel - plain| and the worst
  share of the per-row bound."""
  args = (packed.indptr, packed.indices, packed.data, packed.chunk_row, x,
          packed.windows)
  got, want = KS.spmv_chunked(*args), KS.spmv_chunked_plain(*args)
  again = KS.spmv_chunked(*args)
  diff = (got - want).abs()
  tol = row_tol(packed.indptr, packed.indices, packed.data, x, want)
  share = float((diff / tol.clamp_min(1e-30)).max())
  check(bool((diff <= tol).all()), f"K3c disagrees with its plain version "
        f"on {label}: worst share of the per-row bound {share:.4g}")
  check(bool(torch.equal(got, again)), f"K3c is not deterministic on {label}")
  row, part, dropped, bad_err, row_bound = drop_chunk_head(packed, x, got,
                                                          want, tol)
  print(f"  K3c on {label}: a result without {part} of row {row} "
        f"({dropped} products) is off by {bad_err:.4g} against the row's "
        f"bound {row_bound:.4g}")
  check(bad_err > row_bound, f"K3c's check on {label} passes a result "
        f"without {part}")
  return float(diff.max()), share


def phase_spmv_chunked(device, card: str, big, R):
  """K3c against its plain version on its edge cases in both forms (the
  windowed form each pack holds, and the unwindowed form over the same
  CSR), three x dtypes, bit for bit on repeat; then timed on the urand
  2^22 graph (unwindowed) and ML-20M's R.T (windowed) beside its plain
  version, the other form, K3b and cuSPARSE; returns the R.T row."""
  check_ptxas("spmv_chunked", "chunk_pass", "K3c")
  gen = torch.Generator(device=device).manual_seed(47)
  worst = 0.0
  for label, A in chunk_cases():
    packed = KS.pack_windowed_unique(A)
    check((packed.windows is not None) == (A.nnz > 0),
          f"K3c's pack of {label} is {packed!r}")
    forms = [("unwindowed", None)]
    if packed.windows is not None:
      forms.append((f"{packed.windows.count} window(s)", packed.windows))
    for form, windows in forms:
      for dtype in (torch.float32, torch.bfloat16, torch.float16):
        x = torch.randn(A.shape[1], generator=gen, device=device).to(dtype)
        args = (packed.indptr, packed.indices, packed.data, packed.chunk_row,
                x, windows)
        got, again = KS.spmv_chunked(*args), KS.spmv_chunked(*args)
        want = KS.spmv_chunked_plain(*args)
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs()
        tol = row_tol(packed.indptr, packed.indices, packed.data, x, want)
        err = float(diff.max()) if diff.numel() else 0.0
        share = (float((diff / tol.clamp_min(1e-30)).max()) if diff.numel()
                 else 0.0)
        same = bool(torch.equal(got, again))
        worst = max(worst, err)
        if dtype == torch.float32 or share > 0.5:
          print(f"  K3c {label:26s} {A.shape[0]}x{A.shape[1]} nnz={A.nnz} "
                f"chunks={packed.chunk_row.shape[0]} {form} "
                f"{str(dtype)[6:]}: max|kernel-plain| {err:.3g}, worst share "
                f"of the per-row bound {share:.3g}; repeat bitwise equal: "
                f"{same}")
        check(got.dtype == dtype and got.shape == (A.shape[0],)
              and bool(torch.isfinite(got).all())
              and bool((diff <= tol).all()),
              f"K3c ({form}) disagrees with its plain version on {label} "
              f"{dtype}")
        check(same, f"K3c ({form}) is not deterministic on {label} {dtype}")
  print("  (bfloat16 and float16 lines are printed where a share passes 0.5)")

  timings = {}
  for label, A, form in (("urand 2^22", big, "unwindowed"),
                         ("ML-20M R.T", R.T, "windowed")):
    before = dict(KS.counts)
    with Timer() as t_pack:
      packed = KS.pack_windowed_unique(A)
      torch.cuda.synchronize()
    key = f"chunked_{form}_packs"
    check(KS.counts == dict(before, **{key: before[key] + 1})
          and (packed.windows is not None) == (form == "windowed"),
          f"the unique pack of {label} is {packed!r}, not {form} "
          f"({KS.counts} after {before})")
    n, m = packed.shape
    nnz, nchunks = packed.nnz, packed.chunk_row.shape[0]
    x = torch.randn(m, generator=gen, device=device)
    args = (packed.indptr, packed.indices, packed.data, packed.chunk_row, x)
    err, share = check_spmv_full(packed, x, label)
    worst = max(worst, err)
    lib = torch.sparse_csr_tensor(packed.indptr.int(), packed.indices,
                                  packed.data, size=(n, m),
                                  check_invariants=False)
    csr = (packed.indptr, packed.indices, packed.data)
    fns = {"plain": lambda: KS.spmv_chunked_plain(*args),
           "kernel": lambda: KS.spmv_chunked(*args, packed.windows),
           "K3b": lambda: KS.spmv_csr(*csr, x),
           "cuSPARSE": lambda: lib @ x}
    if packed.windows is not None:
      fns["unwindowed"] = lambda: KS.spmv_chunked(*args)
    t = time_in_turns(fns, 20)
    nbytes = nnz * 8 + (n + 1) * 8 + (m + n) * 4 + nchunks * 8
    bound_ms, bound_by = bound(nbytes, 2 * nnz)
    longest = int((packed.indptr[1:] - packed.indptr[:-1]).max())
    other = (f", the unwindowed form {t['unwindowed']:.4f} ms"
             if "unwindowed" in t else "")
    print(f"  K3c time on {label} (n={n}, m={m}, nnz={nnz}, longest row "
          f"{longest}, {nchunks} chunks; {packed!r} built in "
          f"{t_pack.elapsed:.2f} s): kernel {t['kernel']:.4f} ms "
          f"({nnz / t['kernel'] / 1e6:.2f} Gnnz/s, "
          f"{nbytes / t['kernel'] / 1e6:.1f} GB/s){other}, plain "
          f"{t['plain']:.4f} ms, K3b spmv_csr {t['K3b']:.4f} ms, cuSPARSE "
          f"{t['cuSPARSE']:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}, "
          f"{nbytes / 1e6:.1f} MB); max|kernel-plain| {err:.3g}, "
          f"worst share of the per-row bound {share:.3g}, repeat bitwise "
          f"equal (median of {TIMING_REPS} x 20 calls queued ahead of the "
          f"device, CUDA events, in turns; queued ahead: "
          f"{all(t[f'{v} ahead'] for v in fns)}"
          f"; host issue per call: kernel {t['kernel host']:.4f} ms) on {card}")
    timings[label] = {"ms": t["kernel"], "plain_ms": t["plain"],
                      "library_ms": t["cuSPARSE"], "bound_ms": bound_ms,
                      "bound_by": bound_by}
    del packed, x, args, lib, csr, fns
  return dict(timings["ML-20M R.T"], max_abs_err=worst)


def phase_windowed_entry_point(device, big, R) -> int:
  """make_spmv_windowed over a classic and a unique pack of each matrix:
  each call moves its own kernel's count only, the two routes agree, and a
  float64 x raises.  Returns K3c's launches in this path."""
  gen = torch.Generator(device=device).manual_seed(53)
  for label, A, unique in (("urand 2^22", big, ("chunked_launches",)),
                           ("ML-20M R.T", R.T, ("chunked_launches",
                                                "chunked_windowed_launches"))):
    x = torch.randn(A.shape[1], generator=gen, device=device)
    ys = {}
    for kind, pack, keys in (("classic", KS.pack_windowed, ("csr_launches",)),
                             ("unique", KS.pack_windowed_unique, unique)):
      fn = KS.make_spmv_windowed(pack(A))
      before = dict(KS.counts)
      ys[kind] = fn(x)
      torch.cuda.synchronize()
      check(KS.counts == dict(before, **{k: before[k] + 1 for k in keys}),
            f"make_spmv_windowed on the {kind} pack of {label}: counts "
            f"{KS.counts} after {before}")
      try:
        fn(x.double())
        raised = False
      except NotImplementedError:
        raised = True
      check(raised, f"make_spmv_windowed({kind}) took a float64 x")
      del fn
    packed = KS.pack_windowed(A)
    tol = row_tol(packed.indptr, packed.indices, packed.data, x,
                  ys["classic"])
    diff = (ys["unique"] - ys["classic"]).abs()
    check(bool((diff <= tol).all()), f"the unique and classic routes "
          f"disagree on {label}")
    print(f"  make_spmv_windowed {label}: the classic pack launched K3b once, "
          f"the unique pack K3c once ({', '.join(unique)}); max|unique - "
          f"classic| "
          f"{float(diff.max()):.3g} (per-row bound); a float64 x raised "
          f"NotImplementedError on both")
    del packed, ys, x, diff, tol
  return KS.counts["chunked_launches"]


# -- k-means (config 4) and logistic regression (config 3) ---------------------

def numpy_lloyd(P, c, k: int, iters: int):
  """float64 Lloyd iterations from centers ``c``: labels by argmin of
  ||c||^2 - 2 p.c (ties to the first), centers by one-hot sums."""
  for _ in range(iters):
    labels = np.argmin((c * c).sum(1) - 2.0 * (P @ c.T), axis=1)
    onehot = (labels[:, None] == np.arange(k)[None, :]).astype(np.float64)
    c = (onehot.T @ P) / np.maximum(onehot.sum(0), 1.0)[:, None]
  return c, labels, onehot


def phase_kmeans_logreg(device, card: str):
  """kmeans.fit (one-hot matmul update), the shuffle scatter-add update and
  fit_fused at n = 2^19, d = k = 64 float32 against a float64 NumPy Lloyd
  from the same centers; logistic_reg.fit_fused at n = 2^20, d = 64
  float64 against a NumPy loop."""
  pts, true_c = kmeans.make_data(n=KM_N, d=KM_D, k=KM_K)
  P_host = pts.glom().astype(np.float32)
  del pts
  P = sp.from_numpy(P_host)
  # start next to the true centers: one center a blob, so the labels are
  # decided by wide margins
  c0 = true_c + 0.5 * np.random.default_rng(31).standard_normal(true_c.shape)
  P64 = P_host.astype(np.float64)
  with Timer() as t_np:
    c64, lab64, onehot = numpy_lloyd(P64, c0, KM_K, KM_ITERS)
  # a center is a sum of its m points' exact values over m: a float64 sum
  # in another order lies within 2 (m-1) 2^-53 sum|p| of the oracle's, a
  # float32 sum within (m-1) 2^-24 sum|p|; over m, plus one rounding of
  # the quotient (per center and coordinate)
  sum_abs = onehot.T @ np.abs(P64)
  tol64 = 2.0 ** -52 * (sum_abs + np.abs(c64))
  tol32 = 2.0 ** -24 * (sum_abs + np.abs(c64))
  del onehot
  results = {}
  torch.cuda.synchronize()
  with Timer() as t_fit:
    c_fit, lab_fit = kmeans.fit(P, KM_K, KM_ITERS, centers=sp.from_numpy(c0))
    results["fit (one-hot matmul)"] = (c_fit.glom(), lab_fit.glom(), tol64)
  with Timer() as t_scatter:
    c = sp.from_numpy(c0)
    for _ in range(KM_ITERS):
      lab = kmeans.assign_labels(P, c)
      c = sp.Val(kmeans.update_centers(P, lab, KM_K, use_matmul=False)
                 .evaluate())
    results["shuffle scatter-add"] = (c.glom(), lab.glom(), tol32)
  for label, (cg, lg, tol) in results.items():
    err = np.abs(cg - c64)
    print(f"  k-means {label}, n={KM_N} d={KM_D} k={KM_K} float32 points, "
          f"{KM_ITERS} iterations: labels equal to the float64 Lloyd's: "
          f"{bool(np.array_equal(lg, lab64))}; max|c - c64| {err.max():.3g}, "
          f"worst share of the bound {(err / tol).max():.3g}")
    check(cg.shape == (KM_K, KM_D) and bool(np.isfinite(cg).all()),
          f"k-means {label}: bad centers")
    check(np.array_equal(lg, lab64), f"k-means {label}: labels differ from "
          "the float64 Lloyd's")
    check(bool((err <= tol).all()), f"k-means {label}: centers outside the "
          "bound")
  again = kmeans.update_centers(P, lab, KM_K, use_matmul=False).glom()
  same = bool(np.array_equal(again, results["shuffle scatter-add"][0]))
  print(f"  shuffle scatter-add update repeated: bitwise equal {same}")
  check(same, "the shuffle scatter-add update changed on repeat")
  print(f"  k-means wall: fit {t_fit.elapsed:.3f} s, scatter loop "
        f"{t_scatter.elapsed:.3f} s (host clock, synced, first calls "
        f"included); NumPy float64 Lloyd {t_np.elapsed:.2f} s")

  run = sp.make_fori(
      lambda c_: kmeans.update_centers(P, kmeans.assign_labels(P, c_), KM_K),
      sp.from_numpy(c0))
  c_fori = run(KM_ITERS).glom()
  check(np.allclose(c_fori, results["fit (one-hot matmul)"][0], rtol=1e-12,
                    atol=0), "make_fori's k-means differs from fit")
  torch.cuda.synchronize()
  with Timer() as t_fori:
    run(KM_ITERS).data.sum().item()
  c_fused = kmeans.fit_fused(P, KM_K, KM_ITERS, centers=c0)
  check(isinstance(c_fused, sp.SpartanArray), "fit_fused did not return a "
        "SpartanArray")
  err = np.abs(c_fused.glom() - c64)
  check(c_fused.dtype == torch.float32 and bool((err <= tol32).all()),
        "fit_fused's centers are outside the float32 bound")
  torch.cuda.synchronize()
  with Timer() as t_fused:
    kmeans.fit_fused(P, KM_K, KM_ITERS, centers=c0).data.sum().item()
  print(f"  k-means steady ms/step (host clock, synced): make_fori(update "
        f"o assign) {t_fori.elapsed / KM_ITERS * 1e3:.3f} (equal to fit at "
        f"rtol 1e-12), fit_fused {t_fused.elapsed / KM_ITERS * 1e3:.3f} "
        f"(float32 throughout; max|c - c64| {err.max():.3g}, worst share of "
        f"the float32 bound {(err / tol32).max():.3g}) on {card}")
  del P, run

  X, y, _ = logistic_reg.make_data(n=LINREG_N, d=LINREG_D)
  X_host, y_host = X.glom(), y.glom()
  torch.cuda.synchronize()
  with Timer() as t_fit:
    w = logistic_reg.fit_fused(X, y, LOGREG_STEPS, LOGREG_ALPHA).glom()
  w_np = np.zeros(LINREG_D)
  for _ in range(LOGREG_STEPS):
    pred = 1.0 / (1.0 + np.exp(-(X_host @ w_np)))
    w_np = w_np - LOGREG_ALPHA * (X_host.T @ (pred - y_host) * (1.0 / LINREG_N))
  err = np.abs(w - w_np).max() / np.abs(w_np).max()
  acc = float((np.asarray(logistic_reg.predict(X, w).glom())
               == (y_host > 0.5)).mean())
  run = sp.make_fori(
      lambda w_: logistic_reg.gradient_step(X, y, w_, LOGREG_ALPHA),
      sp.zeros((LINREG_D,)))
  run(2).data.sum().item()
  torch.cuda.synchronize()
  with Timer() as t_steady:
    run(LOGREG_STEPS).data.sum().item()
  print(f"  logistic_reg.fit_fused n={LINREG_N} d={LINREG_D} float64, "
        f"{LOGREG_STEPS} steps: max rel err vs NumPy {err:.3g} (rtol 1e-10); "
        f"training accuracy {acc:.4f}; {t_fit.elapsed:.3f} s with the first "
        f"step's set-up, steady {t_steady.elapsed / LOGREG_STEPS * 1e3:.3f} "
        f"ms/step (host clock, synced) on {card}")
  check(w.shape == (LINREG_D,) and w.dtype == np.float64 and err <= 1e-10,
        "logistic regression disagrees with the NumPy loop")


# -- the sharded kernels on a mesh of p shards of the card ----------------------

SHARD_COUNTS = (2, 4, 8)
ADD_SWEEPS = 20  # the sharded Jacobi call with its add field
SHARDED = ("sharded_onehot_spmv", "sharded_windowed_spmv",
           "sharded_windowed_spmm", "stencil3x3_padded_sharded")


def nonempty(packed) -> int:
  return sum(packed.rows(d)[1] > packed.rows(d)[0]
             for d in range(packed.n_shards))


def sharded_path(p, mesh, graphs, S, u0, f):
  """The main path on a mesh of p shards, with every count at 0 just before
  and read just after: PageRank on both urand graphs, ALS, 200 heat sweeps
  and one Jacobi call with its add field through the sharded stencil.
  Returns the results and each sharded kernel's launches."""
  big_S, _ = graphs["urand 2^22"]
  small_S, _ = graphs["urand 32768"]
  torch.cuda.synchronize()
  for counts in (KS, K5, K6):
    counts.reset_counts()
  with Timer() as t_path:
    out = {"r_big": pagerank.fit_sparse(big_S, PR_ITERS, DAMPING),
           "r_small": pagerank.fit_sparse(small_S, PR_ITERS, DAMPING)}
    out["U"], out["V"] = als.fit(S, k=ALS_K, iterations=ALS_ITERS,
                                 reg=ALS_REG, seed=0)
    out["heat"] = K6.stencil3x3_padded_sharded(u0, HEAT, SWEEPS, mesh)
    out["jacobi"] = K6.stencil3x3_padded_sharded(
        torch.zeros_like(f), JACOBI, ADD_SWEEPS, mesh, add=-0.25 * f)
    torch.cuda.synchronize()
  launches = {"sharded_onehot_spmv": KS.counts["sharded_ell_launches"],
              "sharded_windowed_spmv": KS.counts["sharded_csr_launches"],
              "sharded_windowed_spmm": K5.counts["sharded_launches"],
              "stencil3x3_padded_sharded": K6.counts["k6b_launches"]}
  bands = len(KS.ell_bands(small_S.shape[0], p))
  csr_bands = nonempty(big_S.to_windowed_sharded(p))
  want = {"sharded_onehot_spmv": -(-bands // KS.MAX_BANDS) * PR_ITERS,
          "sharded_windowed_spmv": -(-csr_bands // KS.MAX_BANDS) * PR_ITERS,
          "sharded_windowed_spmm": ALS_ITERS * (
              nonempty(S.to_windowed_spmm_sharded(p))
              + nonempty(S.T.to_windowed_spmm_sharded(p))),
          "stencil3x3_padded_sharded": p * (SWEEPS + ADD_SWEEPS)}
  others = {**{k: v for k, v in KS.counts.items()
               if not k.startswith("sharded_") or "plain" in k},
            "K5 launches": K5.counts["launches"],
            "K5 plain_runs": K5.counts["plain_runs"],
            "K5 sharded_plain_runs": K5.counts["sharded_plain_runs"],
            **{k: v for k, v in K6.counts.items() if k != "k6b_launches"}}
  print(f"  p = {p}: path wall {t_path.elapsed:.2f} s; launches {launches} "
        f"(a shard: " + ", ".join(f"{k} {v / p:g}" for k, v in
                                  launches.items())
        + f"); other kernels and plain runs {others}")
  print(f"  p = {p}: K3a sharded launched "
        f"{launches['sharded_onehot_spmv'] / PR_ITERS:g} times a call over "
        f"{KS.counts['sharded_ell_bands'] / PR_ITERS:g} bands a call; K3d "
        f"{launches['sharded_windowed_spmv'] / PR_ITERS:g} times a call over "
        f"{KS.counts['sharded_csr_bands'] / PR_ITERS:g} bands a call")
  check(launches == want, f"p = {p}: sharded launches {launches}, expected "
        f"{want}")
  check(KS.counts["sharded_ell_bands"] == bands * PR_ITERS,
        f"p = {p}: K3a sharded covered {KS.counts['sharded_ell_bands']} bands "
        f"in {PR_ITERS} calls, expected {bands} a call")
  check(KS.counts["sharded_csr_bands"] == csr_bands * PR_ITERS,
        f"p = {p}: K3d covered {KS.counts['sharded_csr_bands']} bands in "
        f"{PR_ITERS} calls, expected {csr_bands} a call")
  check(not any(others.values()), f"p = {p}: an unsharded kernel or a plain "
        f"version ran on the sharded path ({others})")
  return out, launches


def check_sharded_results(p, out, graphs, als_ref, heat_t, f):
  """The path's results against phase 6's and phase 8's float64 oracles,
  phase 10's K6a field (bit for bit) and a float64 Jacobi oracle."""
  for key, label in (("r_big", "urand 2^22"), ("r_small", "urand 32768")):
    want = graphs[label][1]
    err = float(np.abs(out[key].astype(np.float64) - want).max())
    print(f"  p = {p}: PageRank {label}: max|r - r64| {err:.3g} (<= 1e-5 "
          f"max r64 = {1e-5 * want.max():.3g})")
    check(out[key].shape == want.shape and err <= 1e-5 * want.max(),
          f"p = {p}: sharded PageRank on {label} disagrees with scipy")
  U8, V8, U64, V64, tol = als_ref
  U, V = out["U"], out["V"]
  err_u = np.abs(U - U64).max() / np.abs(U64).max()
  err_v = np.abs(V - V64).max() / np.abs(V64).max()
  same = bool(np.array_equal(U, U8) and np.array_equal(V, V8))
  print(f"  p = {p}: ALS max rel err vs float64 scipy ALS U {err_u:.3g}, V "
        f"{err_v:.3g} (tolerance {tol:.3g}); factors bit-equal to phase "
        f"8's: {same}")
  check(bool(np.isfinite(U).all() and np.isfinite(V).all())
        and max(err_u, err_v) <= tol, f"p = {p}: sharded ALS disagrees")
  same_heat = bool(torch.equal(out["heat"], heat_t))
  print(f"  p = {p}: {SWEEPS} heat sweeps at {GRID_N}^2 float32 bit-equal "
        f"to phase 10's K6a result: {same_heat}")
  check(same_heat, f"p = {p}: the sharded heat sweeps differ from K6a's")
  u, scale = jacobi_oracle(f, ADD_SWEEPS)
  tol = 2 * 5 * 2.0 ** -24 * scale
  err = float((out["jacobi"].double() - u).abs().max())
  print(f"  p = {p}: {ADD_SWEEPS} Jacobi sweeps with the add field: max|u - "
        f"u64| {err:.4g} (tolerance {tol:.4g})")
  check(err <= tol, f"p = {p}: the sharded Jacobi sweeps disagree")
  del u


def held_to(p, name, got, want, tol):
  """|got - want| against the per-entry bound ``tol``; returns the worst
  |got - want| and its worst share of the bound."""
  diff = (got.double() - want.double()).abs()
  share = float((diff / tol.double().clamp_min(1e-300)).max())
  check(bool((diff <= tol.double()).all()), f"p = {p}: {name} disagrees with "
        f"its plain version: worst share of the bound {share:.4g}")
  return float(diff.max()), share


def bit_checks(p, mesh, graphs, S, device, gen):
  """One call of each sharded entry point against its unsharded kernel
  (bit for bit) and against its plain version on the same inputs, at the
  bound the unsharded kernel's full-size check uses (row_tol for the
  SpMVs, spmm_tolerance for the SpMM); returns the worst |kernel - plain|
  of each."""
  big_S, _ = graphs["urand 2^22"]
  small_S, _ = graphs["urand 32768"]
  worst, shares = {}, {}
  x = torch.randn(small_S.shape[1], generator=gen, device=device)
  cols, vals = small_S.cols, small_S.vals
  got = KS.sharded_onehot_spmv(cols, vals, x, mesh)
  check(torch.equal(got, KS.spmv_ell(cols, vals, x)),
        f"p = {p}: sharded_onehot_spmv differs from K3a")
  want = KS.spmv_ell_plain(cols, vals, x)
  worst["sharded_onehot_spmv"], shares["sharded_onehot_spmv"] = held_to(
      p, "sharded_onehot_spmv", got, want,
      row_tol(*small_S.to_csr(), x, want))
  x = torch.randn(big_S.shape[1], generator=gen, device=device)
  got = KS.sharded_windowed_spmv_traced(big_S.to_windowed_sharded(p), x,
                                        mesh)
  check(torch.equal(got, KS.spmv_csr(*big_S.to_csr(), x)),
        f"p = {p}: sharded_windowed_spmv_traced differs from K3b")
  want = KS.spmv_csr_plain(*big_S.to_csr(), x)
  worst["sharded_windowed_spmv"], shares["sharded_windowed_spmv"] = held_to(
      p, "sharded_windowed_spmv_traced", got, want,
      row_tol(*big_S.to_csr(), x, want))
  worst["sharded_windowed_spmm"] = shares["sharded_windowed_spmm"] = 0.0
  for label, A, m in (("R @ V", S, ML_MOVIES), ("R.T @ U", S.T, ML_USERS)):
    B = torch.randn(m, ALS_K, generator=gen, device=device)
    got = K5.sharded_windowed_spmm_traced(A.to_windowed_spmm_sharded(p), B,
                                          mesh)
    check(torch.equal(got, K5.spmm_csr(*A.to_csr(), B)),
          f"p = {p}: sharded_windowed_spmm_traced differs from K5a on "
          f"{label}")
    err, share = held_to(p, f"sharded_windowed_spmm_traced on {label}", got,
                         K5.spmm_csr_plain(*A.to_csr(), B),
                         spmm_tolerance(*A.to_csr(), B))
    worst["sharded_windowed_spmm"] = max(worst["sharded_windowed_spmm"], err)
    shares["sharded_windowed_spmm"] = max(shares["sharded_windowed_spmm"],
                                          share)
    del got, B
  # the long rows of SKEW_ROWS, one in each band at p = 8
  skewed = sparse.from_scipy(skewed_csr())
  for k in (3, ALS_K, 512):
    B = torch.randn(SKEW_M, k, generator=gen, device=device)
    check(torch.equal(
        K5.sharded_windowed_spmm_traced(skewed.to_windowed_spmm_sharded(p), B,
                                        mesh),
        K5.spmm_csr(*skewed.to_csr(), B)),
        f"p = {p}: sharded_windowed_spmm_traced differs from K5a on the "
        f"skewed matrix at k = {k}")
  del skewed, B
  torch.cuda.synchronize()
  print(f"  p = {p}: one call of each sharded SpMV/SpMM entry point "
        f"bit-equal to its unsharded kernel (the SpMM also on the skewed "
        f"matrix at k = 3, {ALS_K}, 512); max|kernel - plain| {worst}, "
        f"worst share of the per-entry bound {shares}")
  return worst


def time_sharded(p, mesh, graphs, S, device, gen, card):
  """Each sharded kernel at the main path's full shape, in turns beside
  the unsharded kernel, the plain version and one library call over the
  whole operand.  The bound counts each input read once and the output
  written once, as the unsharded kernels' bounds do; beside it is printed
  the bound with x (or B, or the halo rows) read once a shard."""
  big_S, _ = graphs["urand 2^22"]
  small_S, _ = graphs["urand 32768"]
  rows = {}

  def report(name, label, t, nbytes, flops, lib, replica_bytes, extra=None):
    bound_ms, bound_by = bound(nbytes, flops)
    replica_ms = bound(nbytes + replica_bytes, flops)[0]
    print(f"  p = {p}: {name} on {label}: kernel {t['kernel']:.4f} ms, "
          f"unsharded {t['unsharded']:.4f} ms ("
          f"{t['kernel'] / t['unsharded']:.3f}x), plain {t['plain']:.4f} ms, "
          f"{lib} {t['library']:.4f} ms, bound {bound_ms:.4f} ms "
          f"({bound_by}, {nbytes / 1e6:.1f} MB, each input read once; "
          f"{replica_ms:.4f} ms with the operand each shard reads again, "
          f"+{replica_bytes / 1e6:.2f} MB) (median of {TIMING_REPS}, "
          f"queued ahead: "
          f"{all(t[f'{v} ahead'] for v in ('kernel', 'unsharded', 'plain', 'library'))}"
          f", CUDA events, in turns; host issue per call: kernel "
          f"{t['kernel host']:.4f} ms) on {card}")
    rows[name] = dict({"ms": t["kernel"], "plain_ms": t["plain"],
                       "library_ms": t["library"], "bound_ms": bound_ms,
                       "bound_by": bound_by, "unsharded_ms": t["unsharded"]},
                      **(extra or {}))

  # K3a sharded at n = 32768
  n, m = small_S.shape
  cols, vals = small_S.cols, small_S.vals
  x = torch.randn(m, generator=gen, device=device)
  indptr, indices, data = small_S.to_csr()
  lib = torch.sparse_csr_tensor(indptr.int(), indices, data, size=(n, m),
                                check_invariants=False)
  t = time_in_turns({
      "plain": lambda: KS.spmv_ell_plain(cols, vals, x),
      "kernel": lambda: KS.sharded_onehot_spmv(cols, vals, x, mesh),
      "unsharded": lambda: KS.spmv_ell(cols, vals, x),
      # about 256 launches a sample: more fill the launch queue, and the
      # host then waits on the device
      "library": lambda: lib @ x}, 256 // p)
  k = small_S.max_nnz_per_row
  report("sharded_onehot_spmv", f"urand 32768 (k={k})", t,
         n * k * 8 + m * 4 + n * 4, 2 * n * k, "cuSPARSE", (p - 1) * m * 4)
  # K3d on urand 2^22
  n, m = big_S.shape
  packed = big_S.to_windowed_sharded(p)
  indptr, indices, data = big_S.to_csr()
  x = torch.randn(m, generator=gen, device=device)
  lib = torch.sparse_csr_tensor(indptr.int(), indices, data, size=(n, m),
                                check_invariants=False)
  t = time_in_turns({
      "plain": lambda: KS.spmv_csr_plain(indptr, indices, data, x),
      "kernel": lambda: KS.sharded_windowed_spmv_traced(packed, x, mesh),
      "unsharded": lambda: KS.spmv_csr(indptr, indices, data, x),
      "library": lambda: lib @ x}, 20)
  report("sharded_windowed_spmv", f"urand 2^22 (nnz={big_S.nnz})", t,
         big_S.nnz * 8 + (n + p) * 8 + m * 4 + n * 4, 2 * big_S.nnz,
         "cuSPARSE", (p - 1) * m * 4)
  # K5b: ALS's two products, summed
  total = {key: 0.0 for key in ("kernel", "unsharded", "plain", "library")}
  total.update({f"{key} {what}": (0.0 if what == "host" else True)
                for key in list(total) for what in ("host", "ahead")})
  nbytes = flops = replicas = 0
  for A, m in ((S, ML_MOVIES), (S.T, ML_USERS)):
    packed = A.to_windowed_spmm_sharded(p)
    csr = A.to_csr()
    B = torch.randn(m, ALS_K, generator=gen, device=device)
    lib = torch.sparse_csr_tensor(csr[0].int(), csr[1], csr[2], size=A.shape,
                                  check_invariants=False)
    t = time_in_turns({
        "plain": lambda: K5.spmm_csr_plain(*csr, B),
        "kernel": lambda: K5.sharded_windowed_spmm_traced(packed, B, mesh),
        "unsharded": lambda: K5.spmm_csr(*csr, B),
        "library": lambda: lib @ B}, 3)
    for key in ("kernel", "unsharded", "plain", "library"):
      total[key] += t[key]
      total[f"{key} host"] += t[f"{key} host"]
      total[f"{key} ahead"] = total[f"{key} ahead"] and t[f"{key} ahead"]
    nbytes += A.nnz * 8 + (A.shape[0] + p) * 8 + m * ALS_K * 4 + (
        A.shape[0] * ALS_K * 4)
    flops += 2 * A.nnz * ALS_K
    replicas += (p - 1) * m * ALS_K * 4
    del lib, B
  report("sharded_windowed_spmm", f"ML-20M R @ V + R.T @ U (k={ALS_K})",
         total, nbytes, flops, "cuSPARSE", replicas)
  # K6b: one sweep at 16384^2 float32 (the halo exchange and p launches)
  n = GRID_N
  u = torch.rand((n, n), generator=gen, device=device)
  bands, bufs, fields = K6._padded_bands(u, p, None)
  xp = K6.to_padded(u)
  buf = torch.zeros_like(xp)
  K6._sharded_sweep(bands, bufs, HEAT, fields)
  one, _ = K6.stencil3x3_padded(xp, buf, HEAT)
  plain, _ = K6.stencil3x3_padded_plain(xp, torch.zeros_like(xp), HEAT)
  sharded = torch.cat([K6.from_padded(b) for b in bands])
  check(torch.equal(sharded, K6.from_padded(one)),
        f"p = {p}: one sharded sweep differs from K6a's")
  err = float((sharded - K6.from_padded(plain)).abs().max())
  check(err == 0.0, f"p = {p}: one sharded sweep differs from its plain "
        f"version by {err:.4g} (float32 is bit for bit)")
  del one, plain, sharded
  w = torch.tensor(HEAT, device=device).view(1, 1, 3, 3)
  u4 = u[None, None]
  t = time_in_turns({
      "plain": lambda: K6.stencil3x3_padded_plain(xp, buf, HEAT),
      "kernel": lambda: K6._sharded_sweep(bands, bufs, HEAT, fields),
      "unsharded": lambda: K6.stencil3x3_padded(xp, buf, HEAT),
      "library": lambda: F.conv2d(u4, w, padding=1)})
  report("stencil3x3_padded_sharded", f"{n}^2 float32, one heat sweep", t,
         8 * n * n, 2 * 5 * n * n, "cuDNN conv2d",
         4 * n * (2 * (p - 1) + 2 * p), {"max_abs_err": err})
  del bands, bufs, xp, buf, u
  return rows


def phase_sharded(device, card: str, graphs, R, als_ref, heat_ref):
  """The sharded kernels K3a sharded, K3d, K5b and K6b on meshes of 2, 4 and
  8 shards of the card: the main path through its entry points (PageRank,
  ALS, heat and Jacobi sweeps) against the earlier phases' oracles and
  results, each sharded entry point bit for bit against its unsharded
  kernel, then timed.  Returns each kernel's row (p = 8's times, launches
  summed over the three meshes)."""
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  gen = torch.Generator(device=device).manual_seed(59)
  u0, heat_result = heat_ref
  heat_t = torch.from_numpy(heat_result).to(device)
  f = torch.randn((GRID_N, GRID_N), generator=gen, device=device)
  with Timer() as t_ingest:
    S = sparse.from_scipy(R, dtype=np.float32)
    S.T.to_csr()
    torch.cuda.synchronize()
  print(f"  the ratings again through sparse.from_scipy and the transpose: "
        f"{t_ingest.elapsed:.2f} s")
  launches = {name: 0 for name in SHARDED}
  worst = {name: 0.0 for name in SHARDED}
  rows = {}
  for p in SHARD_COUNTS:
    mesh = sp.make_mesh(device, shape=(p,))
    with sp.with_mesh(mesh):
      out, path = sharded_path(p, mesh, graphs, S, u0, f)
      check_sharded_results(p, out, graphs, als_ref, heat_t, f)
      del out
      for name in SHARDED:
        launches[name] += path[name]
      for name, err in bit_checks(p, mesh, graphs, S, device, gen).items():
        worst[name] = max(worst[name], err)
      rows = time_sharded(p, mesh, graphs, S, device, gen, card)
      worst["stencil3x3_padded_sharded"] = max(
          worst["stencil3x3_padded_sharded"],
          rows["stencil3x3_padded_sharded"].pop("max_abs_err"))
      try:
        K6.stencil3x3_padded_sharded(u0[:GRID_N - 1], HEAT, 1, mesh)
        raised = False
      except ValueError:
        raised = True
      check(raised, f"p = {p}: a ragged band did not raise")
  del S, heat_t, f
  print(f"  a field of {GRID_N - 1} rows raised ValueError at every p; "
        f"peak device memory in phase 14 "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
  for name in SHARDED:
    rows[name].update(launches=launches[name], max_abs_err=worst[name])
  return rows



# the expression surface at config 1's published 16384^2 float32
SURFACE_N, GATHER_ROWS, GATHER_PAIRS, AT_PAIRS = 16384, 4096, 1 << 22, 1 << 20
PROD_ROWS, NAN_COUNT = 64, 1000


def surface_check(label, got, want, rtol, why, secs):
  """Holds a result (evaluated on the card, fetched) against its float64
  NumPy oracle and prints both with the wall time."""
  got = np.asarray(got)
  want = np.asarray(want)
  check(got.shape == want.shape, f"{label}: shape {got.shape}, expected "
        f"{want.shape}")
  with host_span("compare"):
    if rtol == 0:
      ok = bool(np.array_equal(got, want))
      err = 0.0 if ok else float(np.abs(got.astype(np.float64) - want).max())
    else:
      err = float(np.abs(got.astype(np.float64) - want).max()
                  / max(float(np.abs(want).max()), 1e-300))
      ok = bool(np.isfinite(got).all()) and err <= rtol
  print(f"  {label}: max err {err:.3g} of max|oracle| (tolerance "
        f"{rtol:g}: {why}), wall {secs * 1e3:.1f} ms")
  check(ok, f"{label} disagrees with its NumPy oracle")


def phase_expression_surface(device, card: str) -> int:
  """The core expression surface through the entry points at 16384^2
  float32: K1's new instructions, the new reductions, slices, gathers, a
  boolean mask on the device, .at with duplicates and a NaN reduction,
  each against a float64 NumPy oracle on the host copy.  Returns K1's
  launches."""
  from spartan_tpu_torch.expr import slice as slice_mod
  rng = np.random.default_rng(15)
  host = rng.uniform(-1.0, 3.0, (SURFACE_N, SURFACE_N)).astype(np.float32)
  b = sp.from_numpy(host)
  h64 = host.astype(np.float64)
  K.reset_counts()
  elems = {"(b ** 2).sum()": (lambda: (b ** 2).sum(), host * host),
           "(b // 0.3).sum()": (lambda: (b // 0.3).sum(),
                                host // np.float32(0.3)),
           "(b % 0.7).sum()": (lambda: (b % 0.7).sum(),
                               host % np.float32(0.7))}
  for label, (fn, values) in elems.items():
    before = dict(K.counts)
    with Timer() as t:
      got = float(fn().glom())
    check(K.counts["launches"] == before["launches"] + 1
          and K.counts["routed_plain"] == before["routed_plain"],
          f"{label} did not launch K1 once ({K.counts} after {before})")
    # the chain computes in float32, as NumPy's float32 ufunc does; the sum
    # in float64 in another order
    surface_check(label, got, values.astype(np.float64).sum(), 1e-9,
                  "float64 sums in another order", t.elapsed)
  k1_launches = K.counts["launches"]
  del values
  with Timer() as t:
    got = float(sp.var(b).glom())
  surface_check("sp.var(b)", got, h64.var(), 1e-9,
                "float64 accumulation of float32 values", t.elapsed)
  with Timer() as t:
    got = float(sp.std(b, ddof=1).glom())
  surface_check("sp.std(b, ddof=1)", got, h64.std(ddof=1), 1e-9,
                "float64 accumulation of float32 values", t.elapsed)
  with Timer() as t:
    got = b[:PROD_ROWS].prod(axis=0).glom()
  surface_check(f"b[:{PROD_ROWS}].prod(axis=0)", got,
                h64[:PROD_ROWS].prod(axis=0), 1e-9,
                f"{PROD_ROWS} float64 products in another order", t.elapsed)
  with Timer() as t:
    got = (bool(sp.all(b > -1.5).glom()), bool(sp.any(b > 2.9999).glom()))
  surface_check("sp.all(b > -1.5), sp.any(b > 2.9999)", got,
                (bool((host > -1.5).all()), bool((host > 2.9999).any())), 0,
                "exact", t.elapsed)
  with Timer() as t:
    got = float(b[1:-1, 1:-1].sum().glom())
  surface_check("b[1:-1, 1:-1].sum()", got, h64[1:-1, 1:-1].sum(), 1e-9,
                "float64 sums in another order", t.elapsed)
  with Timer() as t:
    got = float(b[::2].mean().glom())
  surface_check("b[::2].mean()", got, h64[::2].mean(), 1e-9,
                "float64 sums in another order", t.elapsed)
  rows = rng.integers(0, SURFACE_N, GATHER_ROWS)
  with Timer() as t:
    got = b[rows].glom()
  surface_check(f"b[rows] ({GATHER_ROWS} rows, "
                f"{GATHER_ROWS * SURFACE_N * 4 / 1e6:.0f} MB)", got,
                host[rows], 0, "a gather copies", t.elapsed)
  del got
  r2 = rng.integers(0, SURFACE_N, GATHER_PAIRS)
  c2 = rng.integers(0, SURFACE_N, GATHER_PAIRS)
  with Timer() as t:
    got = b[sp.from_numpy(r2), sp.from_numpy(c2)].glom()
  surface_check(f"b[rows, cols] ({GATHER_PAIRS} elements)", got,
                host[r2, c2], 0, "a gather copies", t.elapsed)
  before = slice_mod.counts["boolean_mask_device"]
  with Timer() as t:
    got = b[b > 2.5].glom()
  check(slice_mod.counts["boolean_mask_device"] == before + 1,
        "b[b > 2.5] did not take the device boolean path")
  surface_check(f"b[b > 2.5] ({got.size} elements, on the device)", got,
                host[host > 2.5], 0, "a selection copies", t.elapsed)
  del got
  # .at with duplicates: a quarter of the pairs again
  ar = rng.integers(0, SURFACE_N, AT_PAIRS)
  ac = rng.integers(0, SURFACE_N, AT_PAIRS)
  ar = np.concatenate([ar, ar[:AT_PAIRS // 4]])
  ac = np.concatenate([ac, ac[:AT_PAIRS // 4]])
  with Timer() as t:
    got = b.at[sp.from_numpy(ar), sp.from_numpy(ac)].add(1.0).glom()
  want = h64.copy()
  np.add.at(want, (ar, ac), 1.0)
  # atomics: each updated value is a float32 sum of at most a few terms in
  # an order that varies from run to run: within 4 float32 ulps of the
  # largest |value| of the float64 product
  surface_check(f"b.at[rows, cols].add(1.0) ({ar.size} updates, "
                f"{AT_PAIRS // 4} duplicated)", got, want, 4 * 2.0 ** -24,
                "float32 atomics against np.add.at in float64", t.elapsed)
  del got, want
  nan_r = rng.integers(0, SURFACE_N, NAN_COUNT)
  nan_c = rng.integers(0, SURFACE_N, NAN_COUNT)
  with_nan = h64.copy()
  with_nan[nan_r, nan_c] = np.nan
  with Timer() as t:
    got = float(sp.nanmean(b.at[sp.from_numpy(nan_r), sp.from_numpy(nan_c)]
                           .set(float("nan"))).glom())
  surface_check(f"sp.nanmean(b with {NAN_COUNT} NaN planted)", got,
                np.nanmean(with_nan), 1e-9, "float64 sums in another order",
                t.elapsed)
  del with_nan, h64
  # the contiguous copy inside a sliced sum: K1 takes main.contiguous()
  inner = b.evaluate().data[1:-1, 1:-1]
  copy = inner.contiguous()
  ident = K.plan(None, 0, torch.float32, {})
  t = time_in_turns({
      "sliced sum": lambda: b[1:-1, 1:-1].sum().evaluate(),
      "copy": lambda: inner.contiguous(),
      "K1 on the copy": lambda: K.fused_sum(copy, ident, [], torch.float64),
      "K1 on b": lambda: K.fused_sum(b.evaluate().data, ident, [],
                                     torch.float64)})
  print(f"  b[1:-1, 1:-1].sum() at {SURFACE_N}^2 float32: "
        f"{t['sliced sum']:.4f} ms on the device, of which the contiguous "
        f"copy {t['copy']:.4f} ms ({100 * t['copy'] / t['sliced sum']:.1f} "
        f"%) and K1 on the copy {t['K1 on the copy']:.4f} ms; K1 on the "
        f"whole b {t['K1 on b']:.4f} ms (median of {TIMING_REPS}, CUDA "
        f"events, in turns) on {card}")
  del inner, copy, b
  torch.cuda.empty_cache()
  return k1_launches


BUILTIN_N, BUILTIN_MM_N, LINSPACE_N = 16384, 8192, 1 << 28
KEYS_N, KEY_VALUES, KEY_BINS, TEST_KEYS = 1 << 26, 10 ** 6, 1 << 20, 1000
RESIZE_SHAPE = (12288, 16384)
ORACLE_BLOCKS = 16  # row blocks of each K1 sum's NumPy oracle


def events_ms(fn):
  """(ms between CUDA events around one call of ``fn`` on the device, its
  result): for calls that wait on the host (a length read back), so the
  span holds the host's gaps."""
  marks = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
  marks[0].record()
  out = fn()
  marks[1].record()
  marks[1].synchronize()
  return marks[0].elapsed_time(marks[1]), out


# phase 16's sums through the entry points: (label, the entry point on b,
# the chain K1 runs, NumPy's float32 values, torch's library function, an
# exact op)
BUILTIN_SUMS = [
    ("sp.sum(sp.sin(b))", lambda b: sp.sum(sp.sin(b)), call("sin", V),
     np.sin, torch.sin, False),
    ("sp.sum(sp.tanh(b * 0.5))", lambda b: sp.sum(sp.tanh(b * 0.5)),
     call("tanh", _scaled(0.5)), lambda h: np.tanh(h * np.float32(0.5)),
     lambda x: torch.tanh(x * 0.5), False),
    ("sp.sum(sp.floor(b * 3.0))", lambda b: sp.sum(sp.floor(b * 3.0)),
     call("floor", _scaled(3.0)), lambda h: np.floor(h * np.float32(3.0)),
     lambda x: torch.floor(x * 3.0), True),
    ("sp.sum(sp.log1p(sp.abs(b)))", lambda b: sp.sum(sp.log1p(sp.abs(b))),
     call("log1p", call("absolute", V)), lambda h: np.log1p(np.abs(h)),
     lambda x: torch.log1p(torch.abs(x)), False),
    ("sp.sum(sp.arctan2(b, 0.5))", lambda b: sp.sum(sp.arctan2(b, 0.5)),
     call("arctan2", V, LocalConst(0.5)),
     lambda h: np.arctan2(h, np.float32(0.5)),
     lambda x: torch.atan2(x, torch.tensor(0.5, device=x.device)), False),
    ("sp.sum(sp.hypot(b, 2.0))", lambda b: sp.sum(sp.hypot(b, 2.0)),
     call("hypot", V, LocalConst(2.0)),
     lambda h: np.hypot(h, np.float32(2.0)),
     lambda x: torch.hypot(x, torch.tensor(2.0, device=x.device)), False),
    ("sp.sum(sp.sin(b * 1e6))", lambda b: sp.sum(sp.sin(b * 1e6)),
     call("sin", _scaled(1e6)), lambda h: np.sin(h * np.float32(1e6)),
     lambda x: torch.sin(x * 1e6), False),
]


def _sum_stats(np_fn, host):
  """(sum, sum of |values|) of NumPy's float32 values, in float64."""
  values = np_fn(host)
  return (float(values.sum(dtype=np.float64)),
          float(np.abs(values).sum(dtype=np.float64)))


def builtin_sums(b, host, card: str, pool) -> int:
  """K1 through the entry points on the new ufuncs, each against NumPy's
  float32 values summed in float64 (computed on the host's cores in
  ``pool`` meanwhile) and timed beside its plain version and
  torch.sum(torch.<op>(x)); returns K1's launches."""
  x = b.evaluate().data
  # each oracle in row blocks, so that the host's cores share it (NumPy's
  # float32 sin of arguments past 71476 takes its scalar path)
  step = -(-host.shape[0] // ORACLE_BLOCKS)
  oracles = [[pool.submit(_sum_stats, item[3], host[i:i + step])
              for i in range(0, host.shape[0], step)]
             for item in BUILTIN_SUMS]
  launches = 0
  for (label, entry, chain, np_fn, lib_fn, exact), blocks in zip(
      BUILTIN_SUMS, oracles):
    before = dict(K.counts)
    with Timer() as t:
      got = float(entry(b).glom())
    HOST_SPANS["items"] = HOST_SPANS.get("items", 0.0) + t.elapsed
    check(K.counts["launches"] == before["launches"] + 1
          and K.counts["routed_plain"] == before["routed_plain"],
          f"{label} did not launch K1 once ({K.counts} after {before})")
    launches += 1
    with Timer() as waited, host_span("waiting for NumPy"):
      parts = [f.result() for f in blocks]
    want, scale = sum(p[0] for p in parts), sum(p[1] for p in parts)
    # NumPy's float32 libm and CUDA's agree to an ulp an element (exact
    # ops: the same values); the sums add in other orders
    tol = 1e-9 if exact else 1e-6
    err = abs(got - want) / max(scale, 1e-300)
    program = K.plan(chain, 0, torch.float32, {})
    with host_span("timing in turns"):
      tm = time_in_turns({
          "kernel": lambda p=program: K.fused_sum(x, p, [], torch.float64),
          "plain": lambda p=program: K.fused_sum_plain(x, p, [],
                                                       torch.float64),
          "library": lambda f=lib_fn: torch.sum(f(x), dtype=torch.float64)})
    print(f"  {label}: kernel {got:.17g}, NumPy {want:.17g}, |err| / "
          f"sum|values| {err:.3g} (tolerance {tol:g}); wall "
          f"{t.elapsed * 1e3:.1f} ms (then {waited.elapsed:.2f} s waiting for "
          f"NumPy); device kernel {tm['kernel']:.4f} ms, plain "
          f"{tm['plain']:.4f} ms, torch.sum(torch.<op>(x)) "
          f"{tm['library']:.4f} ms (median of {TIMING_REPS}, CUDA events, "
          f"in turns) on {card}")
    check(np.isfinite(got) and err <= tol,
          f"{label} disagrees with its NumPy oracle")
  return launches


def builtin_matmul(device, card: str) -> int:
  """K2 with a tanh epilogue at 8192^2 bfloat16 through matmul.matmul,
  against a float64 product and tanh on the card (matmul_tol bounds the
  product; tanh is 1-Lipschitz), timed beside its plain version and
  cuBLAS followed by torch.tanh; returns K2's launches."""
  gen = torch.Generator(device=device).manual_seed(16)
  n = BUILTIN_MM_N
  x = torch.randn(n, n, generator=gen, device=device).to(torch.bfloat16)
  y = torch.randn(n, n, generator=gen, device=device).to(torch.bfloat16)
  before = dict(K2.counts)
  with Timer() as t:
    got = K2.matmul(x, y, epilogue=torch.tanh)
    torch.cuda.synchronize()
  check(K2.counts["launches"] == before["launches"] + 1
        and K2.counts["epilogue_unfused"] == before["epilogue_unfused"],
        f"K2 with a tanh epilogue did not launch fused ({K2.counts})")
  prod = x.double() @ y.double()
  want = torch.tanh(prod)
  tol = matmul_tol(x, y, want)
  err = (got.double() - want).abs()
  share = float((err / tol).max())
  del prod, err, tol
  tm = time_in_turns({
      "kernel": lambda: K2.matmul(x, y, epilogue=torch.tanh),
      "plain": lambda: K2.matmul_plain(x, y, torch.tanh),
      "library": lambda: torch.tanh(torch.matmul(x, y))})
  print(f"  K2 tanh(x @ y) at {n}^2 bfloat16: worst share of the bound "
        f"{share:.4g} against float64 (product bound + bfloat16 rounding), "
        f"wall {t.elapsed * 1e3:.1f} ms; device kernel {tm['kernel']:.4f} "
        f"ms, plain {tm['plain']:.4f} ms, cuBLAS + torch.tanh "
        f"{tm['library']:.4f} ms (median of {TIMING_REPS}, CUDA events, in "
        f"turns) on {card}")
  check(share <= 1.0, "K2's tanh epilogue strays from float64")
  del x, y, got, want
  return 1


def builtin_item(label, fn, want, rtol=0.0, why="exact"):
  """One constructor or selection through its entry point: device time
  between events around the evaluation, the wall with the fetch, held to
  NumPy's ``want`` (a future of the host pool) exactly or at ``rtol`` of
  max|oracle|."""
  with Timer() as t:
    ms, arr = events_ms(lambda: fn().evaluate())
    got = arr.data.cpu().numpy()
  HOST_SPANS["items"] = HOST_SPANS.get("items", 0.0) + t.elapsed
  with Timer() as waited, host_span("waiting for NumPy"):
    oracle = want.result()
  surface_check(f"{label} (device {ms:.3f} ms; then {waited.elapsed:.2f} s "
                f"waiting for NumPy)", got, oracle, rtol, why, t.elapsed)
  del got, arr, oracle


def phase_builtins(device, card: str):
  """The elementwise, constructor and selection builtins at config 1's
  16384^2 float32 through the entry points, each against NumPy (its
  oracles computed on six host threads while the card works); returns
  K1's and K2's launches."""
  from spartan_tpu_torch.expr import slice as slice_mod
  rng = np.random.default_rng(16)
  n = BUILTIN_N
  with host_span("draws"):
    host = rng.standard_normal((n, n), dtype=np.float32)
  with host_span("uploads"):
    b = sp.from_numpy(host)
  K.reset_counts()
  pool = concurrent.futures.ThreadPoolExecutor(max_workers=6)
  with pool:
    k1_launches = builtin_sums(b, host, card, pool)
    with Timer() as t:
      k2_launches = builtin_matmul(device, card)
    HOST_SPANS["items"] = HOST_SPANS.get("items", 0.0) + t.elapsed
    torch.cuda.empty_cache()
    with host_span("draws"):
      vec = np.arange(n, dtype=np.float32) * np.float32(0.5)
      pick = rng.integers(0, 3, (n, n), dtype=np.int32)
      rows = host[:, 0] > 0
      keys_host = rng.integers(0, KEY_VALUES, KEYS_N, dtype=np.int32)
      test_host = rng.integers(0, KEY_VALUES, TEST_KEYS, dtype=np.int32)
      grid_i = np.arange(n, dtype=np.int32)
    counted = pool.submit(np.bincount, keys_host, minlength=KEY_BINS)
    want = {
        "eye": pool.submit(np.eye, n),
        "linspace": pool.submit(np.linspace, 0, 1, LINSPACE_N),
        "mesh": [pool.submit(lambda i=i: np.meshgrid(vec, vec)[i])
                 for i in range(2)],
        "zeros_like": pool.submit(np.zeros_like, host),
        "nonzero": pool.submit(lambda: np.stack(np.nonzero(host > 2.5))),
        "compress": pool.submit(np.compress, rows, host, axis=0),
        "choose": pool.submit(lambda: np.choose(
            pick, [host, host * np.float32(2.0), -host], mode="clip")),
        "resize": pool.submit(np.resize, host, RESIZE_SHAPE),
        "unique": pool.submit(lambda: np.flatnonzero(
            counted.result()).astype(np.int32)),
        "isin": pool.submit(np.isin, keys_host, test_host),
        "location": pool.submit(lambda: host.astype(np.float64)
                                + grid_i[:, None] - grid_i[None, :]),
    }
    builtin_item(f"sp.eye({n})", lambda: sp.eye(n), want["eye"])
    builtin_item(f"sp.linspace(0, 1, {LINSPACE_N})",
                 lambda: sp.linspace(0, 1, LINSPACE_N), want["linspace"])
    for i in range(2):
      builtin_item(f"sp.meshgrid(a, a)[{i}] of two {n}-vectors",
                   lambda i=i: sp.meshgrid(vec, vec)[i], want["mesh"][i])
    builtin_item("sp.zeros_like(b)", lambda: sp.zeros_like(b),
                 want["zeros_like"])
    del want["eye"], want["linspace"], want["mesh"], want["zeros_like"]
    torch.cuda.empty_cache()
    sel0 = slice_mod.counts["selection_device"]
    with Timer() as t:
      ms, idx = events_ms(lambda: sp.nonzero(b > 2.5).evaluate())
      got = idx.data.cpu().numpy()
    HOST_SPANS["items"] = HOST_SPANS.get("items", 0.0) + t.elapsed
    surface_check(f"sp.nonzero(b > 2.5) ({got.shape[1]} indices; device "
                  f"{ms:.3f} ms)", got, want.pop("nonzero").result(), 0,
                  "exact", t.elapsed)
    del got, idx
    builtin_item(f"sp.compress of {int(rows.sum())} rows",
                 lambda: sp.compress(rows, b, axis=0), want.pop("compress"))
    builtin_item(f"sp.choose over three {n}^2 choices",
                 lambda: sp.choose(sp.from_numpy(pick), [b, b * 2.0, -b]),
                 want.pop("choose"))
    del pick
    builtin_item(f"sp.resize(b, {RESIZE_SHAPE})",
                 lambda: sp.resize(b, RESIZE_SHAPE), want.pop("resize"))
    keys = sp.from_numpy(keys_host)
    builtin_item(f"sp.unique of {KEYS_N} int32 keys from {KEY_VALUES} "
                 f"values", lambda: sp.unique(keys), want.pop("unique"))
    builtin_item(f"sp.isin(keys, {TEST_KEYS} keys)",
                 lambda: sp.isin(keys, sp.from_numpy(test_host)),
                 want.pop("isin"))
    builtin_item(f"sp.bincount(keys, minlength={KEY_BINS})",
                 lambda: sp.bincount(keys, minlength=KEY_BINS), counted)
    del keys_host, keys, counted
    check(slice_mod.counts["selection_device"] >= sel0 + 4,
          "the selections did not run on the device")
    builtin_item("sp.map_with_location(b, v + c[0] - c[1])",
                 lambda: sp.map_with_location(b,
                                              lambda v, c: v + c[0] - c[1]),
                 want.pop("location"), rtol=2.0 ** -22,
                 why="float32 sums of two coordinates against float64")
    t_exit = time.perf_counter()
  HOST_SPANS["pool exit"] = time.perf_counter() - t_exit
  with host_span("free"):
    del b, host
    torch.cuda.empty_cache()
  return k1_launches, k2_launches


# phase 17: the linear-algebra, statistics, polynomial, histogram and shape
# builtins with concatenate, stack and tile, at config 1's 16384^2 float32
SLICE_N, EINSUM_N, KRON_BLOCK, COV_ROWS = 16384, 4096, 128, 256
HIST_BINS, HIST_RANGE = 1024, (-4.0, 4.0)
INTERP_POINTS, INTERP_KNOTS = 1 << 26, 1 << 20
CONV_N, CONV_TAPS = 1 << 24, 129
TILE_ROWS, TAKE_COLS = 4096, 256
# |norm - oracle| / oracle: |v|**2 rounds once in float32 (all terms
# positive), |v| is exact, powf(|v|, 3) is within a few ulps; the sums are
# float64 in another order
NORM_TOL = {2: 1e-7, 1: 1e-9, 3: 1e-6}


def k1_chain(e):
  """(the fused local op, the main operand's slot, {slot: scalar operand})
  of the reduction inside ``e``, as the evaluator hands them to K1."""
  from spartan_tpu_torch.expr.reduce import ReduceExpr
  nodes = []
  e.optimized().visit(nodes.append)
  red = next(n for n in nodes if isinstance(n, ReduceExpr))
  big = next(k for k, c in enumerate(red.inputs) if c.ndim >= 1)
  scalars = {k: c.leaf_value() for k, c in enumerate(red.inputs) if k != big}
  return red.local_op, big, scalars


def _norm_terms(host, order):
  """NumPy's float64 sum of |v|**order over a block of rows."""
  h = np.abs(host.astype(np.float64))
  return float((h if order == 1 else h ** order).sum())


def slice_norms(b, host, card: str, pool) -> int:
  """``sp.norm(b)``, ``sp.norm(b, 1)`` and ``sp.norm(b, 3)`` through the
  entry point, each one K1 launch, against NumPy's float64 norm (row
  blocks summed on the host's threads), K1's sum timed beside its plain
  version and ``torch.linalg.vector_norm(x, ord, dtype=float64)``;
  returns K1's launches."""
  x = b.evaluate().data
  step = -(-host.shape[0] // ORACLE_BLOCKS)
  oracles = {o: [pool.submit(_norm_terms, host[i:i + step], o)
                 for i in range(0, host.shape[0], step)]
             for o in (2, 1, 3)}
  for order, blocks in oracles.items():
    before = dict(K.counts)
    with Timer() as t:
      got = float(sp.norm(b, order).glom())
    HOST_SPANS["items"] = HOST_SPANS.get("items", 0.0) + t.elapsed
    check(K.counts["launches"] == before["launches"] + 1
          and K.counts["routed_plain"] == before["routed_plain"],
          f"sp.norm(b, {order}) did not launch K1 once ({K.counts} after "
          f"{before})")
    with host_span("waiting for NumPy"):
      want = sum(f.result() for f in blocks) ** (1.0 / order)
    err = rel_err(got, want)
    local_op, big, slots = k1_chain(sp.norm(b, order))
    program = K.plan(local_op, big, torch.float32, slots)
    check(program is not None, f"norm {order}'s chain has no K1 program")
    scalars = [slots[k] for k in sorted(slots)]
    with host_span("timing in turns"):
      tm = time_in_turns({
          "kernel": lambda p=program, s=scalars: K.fused_sum(
              x, p, s, torch.float64),
          "plain": lambda p=program, s=scalars: K.fused_sum_plain(
              x, p, s, torch.float64),
          "library": lambda o=order: torch.linalg.vector_norm(
              x, o, dtype=torch.float64)})
    print(f"  sp.norm(b, {order}): {got:.17g}, NumPy {want:.17g}, relative "
          f"err {err:.3g} (tolerance {NORM_TOL[order]:g}); wall "
          f"{t.elapsed * 1e3:.1f} ms; device K1 sum {tm['kernel']:.4f} ms, "
          f"plain {tm['plain']:.4f} ms, torch.linalg.vector_norm(x, "
          f"{order}, dtype=float64) {tm['library']:.4f} ms (median of "
          f"{TIMING_REPS}, CUDA events, in turns) on {card}")
    check(np.isfinite(got) and err <= NORM_TOL[order],
          f"sp.norm(b, {order}) disagrees with NumPy")
  return len(oracles)


def _held(label, got, oracle, rtol, why, ms, wall):
  """The comparison of one phase 17 item, run on a host thread: ``got``
  against ``oracle()`` exactly (``rtol`` 0), within ``rtol`` of
  max|oracle|, or (a callable ``rtol``) within ``rtol(want)`` an
  element; (passed, its report line)."""
  t0 = time.perf_counter()
  want = oracle()
  got = np.asarray(got)
  if got.shape != want.shape:
    return False, f"  {label}: shape {got.shape}, expected {want.shape}"
  if callable(rtol):
    worst = float((np.abs(got.astype(np.float64) - want)
                   / rtol(want)).max()) if got.size else 0.0
    ok, err, tol = bool(np.isfinite(got).all()) and worst <= 1.0, worst, 1.0
    what = "worst share of the bound"
  elif rtol == 0:
    ok = got.dtype == want.dtype and bool(np.array_equal(got, want))
    err, tol, what = 0.0 if ok else float("nan"), 0, "bit for bit"
  else:
    err = float(np.abs(got.astype(np.float64) - want).max()
                / max(float(np.abs(want).max()), 1e-300))
    ok, tol = bool(np.isfinite(got).all()) and err <= rtol, rtol
    what = "max err of max|oracle|"
  return ok, (f"  {label}: {what} {err:.3g} (tolerance {tol:g}: {why}); "
              f"device {ms:.3f} ms, wall {wall * 1e3:.1f} ms; compared in "
              f"{time.perf_counter() - t0:.2f} s on a host thread")


def slice_item(label, fn, oracle, pool, held, rtol=0.0, why="exact"):
  """One builtin through its entry point: device time between events
  around the evaluation, the wall with the fetch; the comparison with
  NumPy's ``oracle()`` goes to ``pool`` (collected in ``held``)."""
  with Timer() as t:
    ms, arr = events_ms(lambda: fn().evaluate())
    got = arr.data.cpu().numpy()
  HOST_SPANS["items"] = HOST_SPANS.get("items", 0.0) + t.elapsed
  del arr
  held.append(pool.submit(_held, label, got, oracle, rtol, why, ms,
                          t.elapsed))


def _interp_blocks(xq, xp, fp, pool):
  """NumPy's interp of ``xq`` in row blocks on the pool's threads (a
  binary search a point: about 30 s on one core at 2^26 points); the
  oracle waits for them."""
  step = -(-xq.shape[0] // ORACLE_BLOCKS)
  blocks = [pool.submit(np.interp, xq[i:i + step], xp, fp)
            for i in range(0, xq.shape[0], step)]
  return lambda: np.concatenate([f.result() for f in blocks])


def _hist_blocks(host):
  step = -(-host.shape[0] // ORACLE_BLOCKS)
  return sum(np.histogram(host[i:i + step], HIST_BINS, HIST_RANGE)[0]
             for i in range(0, host.shape[0], step))


def phase_slice(device, card: str) -> int:
  """The linear-algebra, statistics, polynomial, histogram and shape
  builtins with concatenate, stack and tile at config 1's 16384^2 float32
  through the entry points: K1 through ``sp.norm``; contractions, shapes
  and statistics each against NumPy (its comparisons on six host threads
  while the card works).  Returns K1's launches."""
  from spartan_tpu_torch.expr.dot import TensorDotExpr
  rng = np.random.default_rng(17)
  n = SLICE_N
  with host_span("draws"):
    host = rng.standard_normal((n, n), dtype=np.float32)
  with host_span("uploads"):
    b = sp.from_numpy(host)
  K.reset_counts()
  held = []
  pool = concurrent.futures.ThreadPoolExecutor(max_workers=6)
  with pool:
    launches = slice_norms(b, host, card, pool)
    # contractions
    with host_span("draws"):
      mats = [rng.standard_normal((EINSUM_N, EINSUM_N), dtype=np.float32)
              for _ in range(3)]
    with host_span("uploads"):
      dev = [sp.from_numpy(m) for m in mats]
    e = sp.einsum("ij,jk,kl->il", *dev)
    dots = []
    e.visit(lambda node: dots.append(node) if isinstance(
        node, TensorDotExpr) else None)
    check(len(dots) == 2, f"einsum of three did not go pairwise ({dots})")
    a64, b64, c64 = (m.astype(np.float64) for m in mats)
    slice_item(f"sp.einsum('ij,jk,kl->il') at {EINSUM_N}^2 (two "
               f"TensorDotExprs, float64)", lambda: e,
               lambda: (a64 @ b64) @ c64, pool, held, 1e-10,
               "float64 products in another order")
    slice_item(f"sp.tensordot(A, B, axes=2) at {EINSUM_N}^2",
               lambda: sp.tensordot(dev[0], dev[1], axes=2),
               lambda: np.asarray((a64 * b64).sum()), pool, held, 1e-10,
               "float64 sums in another order")
    slice_item("sp.vdot(b, b)", lambda: sp.vdot(b, b),
               lambda: np.asarray((host.astype(np.float64) ** 2).sum()),
               pool, held, 1e-7, "float32 products, each rounded once")
    del dev
    kb = (host[:KRON_BLOCK, :KRON_BLOCK], host[KRON_BLOCK:2 * KRON_BLOCK,
                                               :KRON_BLOCK])
    slice_item(f"sp.kron of two {KRON_BLOCK}^2 blocks ({n}^2)",
               lambda: sp.kron(b[:KRON_BLOCK, :KRON_BLOCK],
                               b[KRON_BLOCK:2 * KRON_BLOCK, :KRON_BLOCK]),
               lambda: np.kron(*kb), pool, held, 0,
               "NumPy's float32 products, each rounded once")
    rows64 = host[:COV_ROWS].astype(np.float64)
    slice_item(f"sp.cov(b[:{COV_ROWS}])", lambda: sp.cov(b[:COV_ROWS]),
               lambda: np.cov(rows64), pool, held, 1e-10,
               "float64 sums in another order")
    slice_item(f"sp.corrcoef(b[:{COV_ROWS}])",
               lambda: sp.corrcoef(b[:COV_ROWS]),
               lambda: np.corrcoef(rows64), pool, held, 1e-10,
               "float64 sums in another order")
    torch.cuda.empty_cache()
    # shapes, bit for bit
    shapes = [
        ("sp.concatenate([b, b])", lambda: sp.concatenate([b, b]),
         lambda: np.concatenate([host, host])),
        ("sp.stack([b, b])", lambda: sp.stack([b, b]),
         lambda: np.stack([host, host])),
        (f"sp.tile(b[:{TILE_ROWS}], (2, 1))",
         lambda: sp.tile(b[:TILE_ROWS], (2, 1)),
         lambda: np.tile(host[:TILE_ROWS], (2, 1))),
        ("sp.roll(b, 7, axis=1)", lambda: sp.roll(b, 7, axis=1),
         lambda: np.roll(host, 7, axis=1)),
        ("sp.pad(b, 1, mode='edge')", lambda: sp.pad(b, 1, mode="edge"),
         lambda: np.pad(host, 1, mode="edge")),
        ("sp.rot90(b)", lambda: sp.rot90(b), lambda: np.rot90(host)),
        ("sp.flip(b)", lambda: sp.flip(b), lambda: np.flip(host)),
    ]
    for label, fn, oracle in shapes:
      slice_item(label, fn, oracle, pool, held)
      torch.cuda.empty_cache()
    for i, piece in enumerate(sp.array_split(b, 3)):
      slice_item(f"sp.array_split(b, 3)[{i}]", lambda p=piece: p,
                 lambda i=i: np.array_split(host, 3)[i], pool, held)
    # statistics
    slice_item(f"sp.histogram(b, bins={HIST_BINS}, range={HIST_RANGE})",
               lambda: sp.histogram(b, bins=HIST_BINS, range=HIST_RANGE),
               lambda: _hist_blocks(host), pool, held, 0,
               "edges multiples of 2^-7, exact in float32")
    with host_span("draws"):
      xp = np.sort(rng.uniform(-1.0, 1.0, INTERP_KNOTS))
      fp = rng.standard_normal(INTERP_KNOTS)
      xq = rng.uniform(-1.1, 1.1, INTERP_POINTS)
    with host_span("uploads"):
      dxq, dxp, dfp = sp.from_numpy(xq), sp.from_numpy(xp), sp.from_numpy(fp)
    slice_item(f"sp.interp of {INTERP_POINTS} points over {INTERP_KNOTS} "
               f"knots", lambda: sp.interp(dxq, dxp, dfp),
               _interp_blocks(xq, xp, fp, pool), pool, held, 1e-14,
               "NumPy's float64 operations, an ulp apart at most")
    del dxq, dxp, dfp
    with host_span("draws"):
      sig = rng.standard_normal(CONV_N, dtype=np.float32)
      taps = rng.standard_normal(CONV_TAPS, dtype=np.float32)
    s64, t64 = sig.astype(np.float64), taps.astype(np.float64)
    # a float32 sum of 129 products and its rounding: within 130 float32
    # units of the largest sum of |terms|
    scale = 130 * 2.0 ** -24

    def conv_bound(want, s=s64, t=t64):
      return scale * float(np.convolve(np.abs(s), np.abs(t)).max())

    slice_item(f"sp.convolve of {CONV_N} values with {CONV_TAPS} taps",
               lambda: sp.convolve(sp.from_numpy(sig), sp.from_numpy(taps)),
               lambda: np.convolve(s64, t64), pool, held, conv_bound,
               "130 float32 units of the largest sum of |terms|")
    slice_item("sp.diff(b, axis=1)", lambda: sp.diff(b, axis=1),
               lambda: np.diff(host, axis=1), pool, held, 0,
               "NumPy's float32 differences")
    for axis, part in enumerate(sp.gradient(b)):
      slice_item(f"sp.gradient(b)[{axis}]", lambda p=part: p,
                 lambda a=axis: np.gradient(host, axis=a), pool, held, 0,
                 "NumPy's float32 differences and halvings")
    idx = rng.integers(-n, n, (n, TAKE_COLS))
    slice_item(f"sp.take_along_axis(b, idx, axis=1) ({n} x {TAKE_COLS}, "
               f"negative indices)",
               lambda: sp.take_along_axis(b, sp.from_numpy(idx), 1),
               lambda: np.take_along_axis(host, idx, 1), pool, held)
    packed = sp.packbits(b > 0)
    slice_item("sp.packbits(b > 0)", lambda: packed,
               lambda: np.packbits(host > 0), pool, held)
    slice_item("sp.unpackbits(sp.packbits(b > 0))",
               lambda: sp.unpackbits(packed),
               lambda: (host > 0).reshape(-1).astype(np.uint8), pool, held)
    with host_span("waiting for the comparisons"):
      results = [f.result() for f in held]
    t_exit = time.perf_counter()
  HOST_SPANS["pool exit"] = time.perf_counter() - t_exit
  for ok, line in results:
    print(line)
  for ok, line in results:
    check(ok, f"phase 17 item disagrees with NumPy:{line}")
  with host_span("free"):
    del b, host, held, results
    torch.cuda.empty_cache()
  return launches



# phase 18: the sorts, searches, order statistics and prefix scans at
# config 1's 16384^2 float32
SORT_N = 16384
SORT_SAMPLES = 8  # rows, columns and ranks of each sort held to NumPy
STABLE_KEYS = 1 << 26
SEARCH_QUERIES, SEARCH_BOUNDS = 1 << 26, 1 << 20
PERM_N = 1 << 26
LSE_N = 1 << 24
NAN_SHARE = 2.0 ** -16  # of b's entries, besides one in each sampled row
STATS_Q = (1, 50, 99)
F32_ULP = 2.0 ** -23


def _agree(label, got, oracle, tol, why):
  """Run on a host thread: ``got`` against NumPy's ``oracle()``, NaN
  where NumPy has NaN and the rest exactly in NumPy's dtype (``tol`` 0)
  or each element within ``tol(want)``; (passed, its report line)."""
  t0 = time.perf_counter()
  want = np.asarray(oracle())
  got = np.asarray(got)
  if got.shape != want.shape:
    return False, f"  {label}: shape {got.shape}, expected {want.shape}"
  nan_w = np.isnan(want) if want.dtype.kind == "f" else np.zeros(
      want.shape, bool)
  nan_g = np.isnan(got) if got.dtype.kind == "f" else np.zeros(
      got.shape, bool)
  ok = bool(np.array_equal(nan_g, nan_w))
  g, w = got[~nan_w], want[~nan_w]
  if tol == 0:
    ok = ok and got.dtype == want.dtype and bool(np.array_equal(g, w))
    if ok and got.dtype.kind == "f":  # -0.0 and +0.0 in NumPy's places
      ok = bool(np.array_equal(np.signbit(g), np.signbit(w)))
    what, err = "bit for bit", 0.0 if ok else float("nan")
  else:
    err = float((np.abs(g.astype(np.float64) - w) / tol(w)).max()
                if g.size else 0.0)
    ok, what = ok and err <= 1.0, "worst share of the bound"
  return ok, (f"  {label}: {what} {err:.3g} ({why}); NaN at "
              f"{int(nan_w.sum())} places; compared in "
              f"{time.perf_counter() - t0:.2f} s on a host thread")


def _evaluated(label, fn):
  """``fn()`` (an expr) evaluated, then evaluated again by ``event_ms``,
  queued behind a spin so that the CUDA events time the card and not the
  host's gaps while six threads run NumPy's comparisons (the first call
  grows the allocator's pool to the item's buffers): the second call's
  device time, printed, and the first call's tensor."""
  with Timer() as t:
    arr = fn().evaluate()
    ms, host, ahead = event_ms(lambda: fn().evaluate())
  HOST_SPANS["items"] = HOST_SPANS.get("items", 0.0) + t.elapsed
  print(f"  {label}: device {ms:.3f} ms (second call, queued ahead: "
        f"{ahead}, host issue {host:.1f} ms), wall of both "
        f"{t.elapsed * 1e3:.1f} ms")
  return arr.data


def _checked_on_card(label, x, s, idx, axis) -> None:
  """A sort along ``axis`` (None: of the raveled array) held on the card:
  non-decreasing, the indices a permutation of each slice (each
  slice-and-index key counted once by ``bincount``), increasing inside
  each run of equal values (stable), and ``x`` gathered by them equal to
  the sort."""
  d = 0 if axis is None else axis
  xs = x.reshape(-1) if axis is None else x
  m = s.shape[d]
  lo, hi = s.narrow(d, 0, m - 1), s.narrow(d, 1, m - 1)
  rising = bool((hi >= lo).all())
  stable = bool(((hi != lo) | (idx.narrow(d, 1, m - 1)
                               > idx.narrow(d, 0, m - 1))).all())
  gathered = bool(torch.equal(torch.take_along_dim(xs, idx, d), s))
  if axis is None:
    keys = idx
  else:
    line = torch.arange(SORT_N, device=x.device)
    keys = (idx + line[:, None] * SORT_N if axis == 1
            else idx * SORT_N + line[None, :])
  once = bool((torch.bincount(keys.reshape(-1), minlength=keys.numel())
               == 1).all())
  del keys
  print(f"  {label} on the card: non-decreasing {rising}, a permutation "
        f"{once}, stable {stable}, the gather equal to the sort {gathered}")
  check(rising and once and stable and gathered,
        f"{label} failed its checks on the card")


def _sorts(b, x, host, lines, rng, pool, hold) -> None:
  """``sp.sort``/``sp.argsort`` along each axis and of the raveled 2^28
  elements, held on the card, sampled slices held to NumPy."""
  flat = host.reshape(-1)
  ranks = np.sort(rng.choice(flat.size, SORT_SAMPLES, replace=False))
  for axis in (1, 0, None):
    s = _evaluated(f"sp.sort(b, axis={axis})", lambda: sp.sort(b, axis=axis))
    idx = _evaluated(f"sp.argsort(b, axis={axis})",
                     lambda: sp.argsort(b, axis=axis))
    _checked_on_card(f"sort and argsort along axis {axis}", x, s, idx, axis)
    if axis == 1:
      part = host[lines]
      hold(f"sp.sort(b, axis=1), {SORT_SAMPLES} rows", s[lines].cpu(),
           lambda p=part: np.sort(p, axis=1))
      hold(f"sp.argsort(b, axis=1), {SORT_SAMPLES} rows", idx[lines].cpu(),
           lambda p=part: np.argsort(p, axis=1, kind="stable"))
    elif axis == 0:
      part = host[:, lines]
      hold(f"sp.sort(b, axis=0), {SORT_SAMPLES} columns",
           s[:, lines].cpu(), lambda p=part: np.sort(p, axis=0))
      hold(f"sp.argsort(b, axis=0), {SORT_SAMPLES} columns",
           idx[:, lines].cpu(),
           lambda p=part: np.argsort(p, axis=0, kind="stable"))
    else:
      at = torch.from_numpy(ranks).to(x.device)
      ranked = pool.submit(lambda: np.partition(flat, ranks)[ranks])
      hold(f"sp.sort(b, axis=None) at {SORT_SAMPLES} ranks of {flat.size}",
           s[at].cpu(), ranked.result)
      hold("sp.argsort(b, axis=None) at those ranks, gathered",
           flat[idx[at].cpu().numpy()], ranked.result)
    del s, idx
    torch.cuda.empty_cache()


def _stable_keys(rng):
  """2^26 keys of each kind that stress a sort's stability."""
  k = STABLE_KEYS
  ints = rng.integers(0, 16, k, dtype=np.int32)
  zeros = rng.choice(np.array([-1.0, -0.0, 0.0, 1.0], np.float32), k)
  nans = rng.standard_normal(k, dtype=np.float32)
  nans[rng.random(k) < 0.05] = np.nan
  nans[rng.random(k) < 0.05] = -np.nan  # the sign bit set
  nans[rng.random(k) < 0.05] = np.float32(-0.0)
  nans[rng.random(k) < 0.05] = np.float32(0.0)
  return {"int32 keys in [0, 16)": ints,
          "float32 keys of -1, -0.0, +0.0 and 1": zeros,
          "float32 normal keys, 5% NaN, 5% -NaN, 5% -0.0, 5% +0.0": nans}


def _scans(b, bn, x, host, hostn, lines, hold) -> None:
  """cumsum in float64 along axis 1 (sampled rows) and of the raveled
  array (whole), cumprod (sampled rows), and cummax/cummin carrying NaN
  (sampled rows and columns), against NumPy."""
  n = SORT_N
  for axis in (1, None):
    got = _evaluated(f"sp.cumsum(b, axis={axis})",
                     lambda: sp.cumsum(b, axis=axis))
    check(got.dtype == torch.float64,
          f"cumsum of float32 accumulated in {got.dtype}, not float64")
    running = torch.cumsum(x.abs().reshape(-1) if axis is None else x.abs(),
                           0 if axis is None else axis, dtype=torch.float64)
    scale = float(running.max())
    del running
    tol = (lambda w, c=scale: np.full(w.shape, 1e-9 * c))
    why = ("float64 sums in another order: 1e-9 of the largest running sum "
           "of |b| (float32 sums would stray about 6e-8 of it)")
    if axis is None:
      hold("sp.cumsum(b, axis=None) (float64), whole", got.cpu(),
           lambda: np.cumsum(host, dtype=np.float64), tol, why)
    else:
      hold(f"sp.cumsum(b, axis=1) (float64), {SORT_SAMPLES} rows",
           got[lines].cpu(),
           lambda: np.cumsum(host[lines], axis=1, dtype=np.float64), tol,
           why)
    del got
  got = _evaluated("sp.cumprod(1 + 0.001 * b, axis=1)",
                   lambda: sp.cumprod(1 + 0.001 * b, axis=1))
  hold(f"sp.cumprod(1 + 0.001 * b, axis=1) (float64), {SORT_SAMPLES} rows",
       got[lines].cpu(),
       lambda: np.cumprod(1 + 0.001 * host[lines], axis=1, dtype=np.float64),
       lambda w: 1e-10 * np.abs(w),
       f"float64 products: 1e-10 of each value ({n} factors at most)")
  del got
  for name, ufunc in (("cummax", np.maximum), ("cummin", np.minimum)):
    for axis in (1, 0):
      got = _evaluated(f"sp.{name}(b with NaN, axis={axis})",
                       lambda f=getattr(sp, name), a=axis: f(bn, axis=a))
      pick = (lambda t: t[lines]) if axis == 1 else (lambda t: t[:, lines])
      hold(f"sp.{name}(b with NaN, axis={axis}), {SORT_SAMPLES} "
           f"{'rows' if axis == 1 else 'columns'}", pick(got).cpu(),
           lambda u=ufunc, a=axis, p=pick: u.accumulate(p(hostn), axis=a))
      del got
  torch.cuda.empty_cache()


def _nan_planted(host, lines, rng):
  """``host`` with NAN_SHARE of its entries NaN and one NaN in each of the
  sampled ``lines`` as rows and as columns, half of them with the sign
  bit set."""
  out = host.copy()
  n = host.shape[1]
  at = np.concatenate([rng.integers(0, out.size, int(out.size * NAN_SHARE)),
                       lines * n + rng.integers(0, n, lines.size),
                       rng.integers(0, n, lines.size) * n + lines])
  out.reshape(-1)[at] = np.where(np.arange(at.size) % 2 == 0, np.nan,
                                 -np.nan).astype(np.float32)
  return out


def _order_statistics(b, bn, host, hostn, lines, hold) -> None:
  """median, percentile(q=[1, 50, 99]) and nanmedian with NaN planted,
  of the whole array and along axis 1 (sampled rows held to NumPy's
  float64 values, rounded once to float32 as the port's are)."""
  one_ulp = lambda w: F32_ULP * np.maximum(np.abs(w), 1e-30)
  why = "one float32 ulp: NumPy's float64 order statistics rounded once"
  q = list(STATS_Q)
  rows = host[lines].astype(np.float64)
  rows_n = hostn[lines].astype(np.float64)
  items = [
      ("sp.median(b)", lambda: sp.median(b),
       lambda: np.median(host.astype(np.float64))),
      (f"sp.percentile(b, {q})", lambda: sp.percentile(b, q),
       lambda: np.percentile(host.astype(np.float64), q)),
      ("sp.nanmedian(b with NaN)", lambda: sp.nanmedian(bn),
       lambda: np.nanmedian(hostn.astype(np.float64))),
  ]
  for label, fn, oracle in items:
    got = _evaluated(label, fn)
    hold(label, got.cpu(), oracle, one_ulp, why)
  axis_items = [
      ("sp.median(b, axis=1)", lambda: sp.median(b, axis=1),
       lambda: np.median(rows, axis=1), lambda t: t[lines]),
      (f"sp.percentile(b, {q}, axis=1)", lambda: sp.percentile(b, q, axis=1),
       lambda: np.percentile(rows, q, axis=1), lambda t: t[:, lines]),
      ("sp.nanmedian(b with NaN, axis=1)", lambda: sp.nanmedian(bn, axis=1),
       lambda: np.nanmedian(rows_n, axis=1), lambda t: t[lines]),
      ("sp.median(b with NaN, axis=1)", lambda: sp.median(bn, axis=1),
       lambda: np.median(rows_n, axis=1), lambda t: t[lines]),
  ]
  for label, fn, oracle, pick in axis_items:
    got = _evaluated(label, fn)
    hold(f"{label}, {SORT_SAMPLES} rows", pick(got).cpu(), oracle, one_ulp,
         why)
  torch.cuda.empty_cache()


def _searches(rng, pool, hold) -> None:
  """searchsorted (both sides) and digitize (increasing and decreasing
  bins, both sides) of 2^26 queries into 2^20 boundaries with ties,
  exactly; NumPy's searches in blocks on the pool."""
  bounds = np.sort(rng.standard_normal(SEARCH_BOUNDS, dtype=np.float32))
  bounds[1::97] = bounds[0::97][:bounds[1::97].size]  # runs of ties
  bounds = np.sort(bounds)
  queries = rng.standard_normal(SEARCH_QUERIES, dtype=np.float32)
  queries[::101] = bounds[rng.integers(0, bounds.size,
                                       queries[::101].size)]
  desc = bounds[::-1].copy()
  db, dq, dd = sp.from_numpy(bounds), sp.from_numpy(queries), \
      sp.from_numpy(desc)
  step = -(-queries.size // ORACLE_BLOCKS)

  def blocks(fn):
    parts = [pool.submit(fn, queries[i:i + step])
             for i in range(0, queries.size, step)]
    return lambda: np.concatenate([f.result() for f in parts])

  for side in ("left", "right"):
    oracle = blocks(lambda v, s=side: np.searchsorted(bounds, v, side=s))
    got = _evaluated(f"sp.searchsorted(bounds, queries, side={side!r})",
                     lambda s=side: sp.searchsorted(db, dq, side=s))
    hold(f"sp.searchsorted of {queries.size} queries into {bounds.size} "
         f"boundaries, side={side!r}", got.cpu(), oracle)
  for label, bins, dbins in (("increasing", bounds, db),
                             ("decreasing", desc, dd)):
    for right in (False, True):
      oracle = blocks(lambda v, b_=bins, r=right: np.digitize(v, b_, r))
      got = _evaluated(f"sp.digitize(queries, {label} bins, right={right})",
                       lambda d=dbins, r=right: sp.digitize(dq, d, r))
      hold(f"sp.digitize, {label} bins, right={right}", got.cpu(), oracle)
  del db, dq, dd


def phase_sorts(device, card: str) -> None:
  """The sorts, searches, order statistics and prefix scans at config 1's
  16384^2 float32 through the entry points: each held on the card where
  it can be (a sort non-decreasing, its argsort a stable permutation),
  and against NumPy on six host threads while the card works."""
  rng = np.random.default_rng(18)
  n = SORT_N
  lines = np.sort(rng.choice(n, SORT_SAMPLES, replace=False))
  with host_span("draws"):
    host = rng.standard_normal((n, n), dtype=np.float32)
    hostn = _nan_planted(host, lines, rng)
    keys = _stable_keys(rng)
    lse = rng.standard_normal(LSE_N, dtype=np.float32)
  with host_span("uploads"):
    b, bn = sp.from_numpy(host), sp.from_numpy(hostn)
  x = b.evaluate().data
  held = []
  pool = concurrent.futures.ThreadPoolExecutor(max_workers=6)

  def hold(label, got, oracle, tol=0, why="exact"):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    held.append(pool.submit(_agree, label, got, oracle, tol, why))

  with pool:
    _sorts(b, x, host, lines, rng, pool, hold)
    for label, k in keys.items():
      with host_span("uploads"):
        dk = sp.from_numpy(k)
      got = _evaluated(f"sp.argsort of {k.size} {label}",
                       lambda: sp.argsort(dk))
      hold(f"sp.argsort of {k.size} {label}", got.cpu(),
           lambda k=k: np.argsort(k, kind="stable"))
      del dk, got
    _scans(b, bn, x, host, hostn, lines, hold)
    _order_statistics(b, bn, host, hostn, lines, hold)
    _searches(rng, pool, hold)
    got = _evaluated(f"sp.permutation({PERM_N})",
                     lambda: sp.permutation(PERM_N))
    once = bool((torch.bincount(got, minlength=PERM_N) == 1).all())
    print(f"  sp.permutation({PERM_N}) on the card: a permutation {once}")
    check(once and got.numel() == PERM_N,
          "sp.permutation is not a permutation")
    del got
    # 2·log2(n) logaddexp steps deep, each within 2 float32 ulps
    depth = 2 * int(np.ceil(np.log2(LSE_N)))
    got = _evaluated(f"sp.scan(v, scan_fn=torch.logaddexp) of {LSE_N}",
                     lambda: sp.scan(sp.from_numpy(lse),
                                     scan_fn=torch.logaddexp))
    hold(f"sp.scan(v, scan_fn=torch.logaddexp) of {LSE_N} (float32)",
         got.cpu(), lambda: np.logaddexp.accumulate(lse.astype(np.float64)),
         lambda w: (depth + 1) * 2 * 2.0 ** -24 * np.maximum(np.abs(w), 1.0),
         f"{depth} steps deep, 2 float32 ulps each, of max(|value|, 1)")
    del got
    with host_span("waiting for the comparisons"):
      results = [f.result() for f in held]
  for ok, line in results:
    print(line)
  for ok, line in results:
    check(ok, f"phase 18 item disagrees with NumPy:{line}")
  with host_span("free"):
    del b, bn, x, host, hostn, held, results
    torch.cuda.empty_cache()


# phase 19: while_loop, scan_iters and cond, and the Krylov solvers of
# sp.sparse.linalg in float32 with their matvecs on K3a/K3b (K3d on a mesh
# of 8 shards)
GRID_SIDE = 2048  # the heat and convection-diffusion grids: n = 2^22
HEAT_C = 100.0  # backward Euler, c = dt/h^2: kappa about 1 + 8c = 801
# I + c (L + v D_x), D_x the upwind difference; |A|_inf = 1 + c (8 + 2v)
# = 25 at c = 2, small enough that gmres's Krylov estimate of its residual
# stays well inside rtol of the true float32 residual its final check reads
CONV_C, CONV_V = 2.0, 2.0
SOLVE_N = 32768  # the K3a systems
SPD_DEGREE = 8  # _sparse_spd's G: G + G.T has about 16 entries a row
REGULAR_PERMS, REGULAR_SHIFT = 8, 12.0  # W: 16-regular; A = 12 I - W
TALL_M, TALL_N, TALL_K = 1 << 22, 1 << 20, 8
SCAN_STEPS = 50
SOLVE_SHARDS = 8
# the solves' tolerances: reachable in float32 at these condition numbers
# (gmres's final check is a true residual, which float32 keeps near 1e-5
# here, so its rtol is 1e-4)
RTOL = {"cg": 1e-5, "bicgstab": 1e-5, "gmres": 1e-4, "minres": 1e-5}
LS_TOL = 1e-5
EPS64 = 2.0 ** -53
ORACLE_RTOL, ORACLE_ITERS = 1e-8, 1000  # scipy's float64 cg
# the heat step's scipy cg, in a worker process that phase 19 waits for:
# 600x below the bound x's own residual is held to (6.3e-4)
HEAT_ORACLE_RTOL = 1e-6
MINRES_ORACLE_RTOL = 1e-10  # scipy's float64 minres, up to ORACLE_ITERS
TIMING_SAMPLES = 7


def grid_laplacian(side: int):
  """The 5-point Laplacian (4 on the diagonal, -1 to each neighbour, a
  Dirichlet boundary) on a side x side grid, row-major, float64 CSR."""
  t = ss.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(side, side))
  eye = ss.identity(side)
  return (ss.kron(eye, t) + ss.kron(t, eye)).tocsr()


def heat_system(side: int):
  """One backward-Euler heat step (I + c L) u = u0 on a side^2 grid: SPD,
  5 entries a row, kappa about 801, strictly diagonally dominant by rows
  with margin 1 (so ||A^-1||_inf <= 1); and u0, uniform in [0, 1)."""
  u0 = np.random.default_rng(190).random(side ** 2, dtype=np.float32)
  return (ss.identity(side ** 2) + HEAT_C * grid_laplacian(side)).tocsr(), u0


def convection_system(side: int):
  """Convection-diffusion, I + c (L + v D_x) with D_x the upwind (west)
  difference: nonsymmetric, 5 entries a row, strictly diagonally dominant
  by rows with margin 1."""
  d = ss.diags([-1.0, 1.0], [-1, 0], shape=(side, side))
  upwind = ss.kron(ss.identity(side), d)
  return (ss.identity(side ** 2)
          + CONV_C * (grid_laplacian(side) + CONV_V * upwind)).tocsr()


def spd_system():
  """The reference test's ``_sparse_spd`` construction
  (tests/test_sparse_linalg.py:20-25) at n = 32768: G + G.T plus the
  diagonal of its row sums + 1, about 17 entries a row, margin 1."""
  # a Generator, not the test's RandomState: RandomState draws the
  # positions through a permutation of all n^2 = 2^30 of them
  g = ss.random(SOLVE_N, SOLVE_N, density=SPD_DEGREE / SOLVE_N,
                random_state=np.random.default_rng(2), format="csr")
  a = (g + g.T).tocsr()
  return (a + ss.diags(np.asarray(np.abs(a).sum(axis=1)).ravel() + 1.0)
          ).tocsr()


def indefinite_system():
  """A shifted graph Laplacian: W the adjacency of a random 16-regular
  multigraph (8 random permutations and their transposes), A = 12 I - W =
  (16 I - W) - 4 I.  The constant vector has eigenvalue -4; the others
  are 12 - (W's other eigenvalues, within about +-7.75), so A is
  indefinite and well conditioned.  Returns A and W."""
  rng = np.random.default_rng(19)
  n = SOLVE_N
  rows = np.tile(np.arange(n), REGULAR_PERMS)
  cols = np.concatenate([rng.permutation(n) for _ in range(REGULAR_PERMS)])
  p = ss.csr_matrix((np.ones(rows.size), (rows, cols)), shape=(n, n))
  w = (p + p.T).tocsr()
  return (REGULAR_SHIFT * ss.identity(n) - w).tocsr(), w


def tall_system(m: int, n: int, k: int):
  """A tall sparse least-squares system, m x n, k entries a row at uniform
  random columns, standard normal values; b standard normal."""
  rng = np.random.default_rng(23)
  cols = rng.integers(0, n, m * k, dtype=np.int32)
  vals = rng.standard_normal(m * k, dtype=np.float32)
  indptr = np.arange(0, m * k + 1, k, dtype=np.int64)
  a = ss.csr_matrix((vals, cols, indptr), shape=(m, n))
  a.sum_duplicates()
  return a, rng.standard_normal(m).astype(np.float32)


def csr64(a, device):
  """``a`` as a float64 torch CSR tensor on ``device`` (the residual
  oracle's operand: cuSPARSE on the card)."""
  a = ss.csr_matrix(a, dtype=np.float64)
  return torch.sparse_csr_tensor(
      torch.from_numpy(a.indptr.astype(np.int64)),
      torch.from_numpy(a.indices.astype(np.int64)),
      torch.from_numpy(a.data), size=a.shape).to(device)


def matvec64(a64, x: torch.Tensor) -> torch.Tensor:
  return (a64 @ x.double().unsqueeze(1)).squeeze(1)


def norm2_bound(a) -> float:
  """sqrt(|A|_1 |A|_inf) of a scipy matrix, an upper bound of |A|_2."""
  a = abs(a)
  return float(np.sqrt(a.sum(axis=0).max() * a.sum(axis=1).max()))


def norm64(v: torch.Tensor) -> float:
  return float(torch.linalg.vector_norm(v.double()))


def counted_solve(label, name, call, key: str):
  """``call()`` (a solve of ``name``) once with the SpMV counts set to 0
  just before it: the x tensor, the rest of its result, its iterations,
  and its kernel launches (``key``: the counts' ``ell``, ``csr`` or
  ``sharded_csr``), checked against the matvec count and no plain run."""
  KS.reset_counts()
  with spl._loops_run() as runs, Timer() as t:
    out = call()
    x = out[0].data if hasattr(out[0], "data") else out[0].evaluate().data
    torch.cuda.synchronize()
  iters = spl._iterations(name, runs[-1][0])
  per, extra = spl._MATVECS[name]
  want = per * iters + extra
  launches = KS.counts[f"{key}_launches"]
  plain = KS.counts[f"{key}_plain_runs"]
  print(f"  {label}: {name} {iters} iterations, result {out[1:]}, "
        f"{key} launches {launches} = {per} x {iters} + {extra} matvecs, "
        f"plain runs {plain}; first call {t.elapsed:.2f} s")
  check(launches == want and plain == 0,
        f"{label}: {launches} {key} launches and {plain} plain runs for "
        f"{want} matvecs")
  return x, out[1:], iters, launches


def timed_solve(label, name, solve, iters: int, kernel: str):
  """Host and device ms an iteration of ``solve(**limit)``, for the full
  solve (``iters`` iterations) and one cut to about a quarter as many by
  its iteration limit.  Host: the wall of the solve's ``while_loop`` call,
  the median of TIMING_SAMPLES calls; each iteration reads its condition
  on the host, so that wall holds every iteration's issue and its wait for
  the card.  Differenced between the two limits over the difference of
  their iterations, which takes out the call's entry and its wait for the
  work queued before the loop.  Device: the kernels of one whole solve
  under torch.profiler, differenced the same way (``kernel``'s part
  apart).  The idle share 1 - device / host is printed as it comes: since
  every iteration waits for the card, host below device says only that
  the two differences agree within their noise, and is flagged so.
  Returns the host and device ms an iteration (device None if not
  measured)."""
  if name == "gmres":
    short = {"maxiter": 1}  # one restart cycle
  else:
    short = {{"lsqr": "iter_lim"}.get(name, "maxiter"): max(1, iters // 4)}
  runs = []
  for limit in ({}, short):
    with spl._loops_run() as loops:
      solve(**limit)  # builds this limit's steps
      for _ in range(TIMING_SAMPLES):
        torch.cuda.synchronize()
        solve(**limit)
    k = spl._iterations(name, loops[-1][0])
    wall = statistics.median(sec for _, sec in loops[1:]) * 1e3
    by_name, dev_ms, _ = device_share(lambda: solve(**limit))
    spmv = sum(v for key, v in by_name.items() if kernel in key)
    runs.append((k, wall, dev_ms, spmv))
  (k1, wall1, dev1, spmv1), (k0, wall0, dev0, spmv0) = runs
  host = (wall1 - wall0) / (k1 - k0)
  head = (f"  {label}: {k1} and {k0} iterations, their loops {wall1:.3f} and "
          f"{wall0:.3f} ms (median of {TIMING_SAMPLES}): host {host:.4f} ms "
          f"an iteration")
  if dev1 is None or dev0 is None:
    print(f"{head}; device time not measured")
    return host, None
  dev = (dev1 - dev0) / (k1 - k0)
  print(f"{head}, device {dev:.4f} ms ({kernel} "
        f"{(spmv1 - spmv0) / (k1 - k0):.4f}), 1 - device / host "
        f"{1.0 - dev / host:.3f}")
  if host < dev:
    print(f"  FLAG {label}: host below device by {dev - host:.4f} ms an "
          "iteration, which one sync an iteration rules out: the loop is "
          "bound by the card within this estimate's noise; no idle share")
  return host, dev


def hold_solve(label, a64, x, b64, rtol, iters, a_norm, inv_norm,
               oracle=None):
  """float64 on the card: x's true residual |b - A x|_2 / |b|_2 against the
  bound that rtol, the iterations and |A|_2 |A^-1|_2 fix (|x|_2 <=
  |A^-1|_2 |b|_2; ``a_norm`` and ``inv_norm`` upper bounds of |A|_2 and
  |A^-1|_2).  With ``oracle`` = (x64 on the host, its residual bound): the
  oracle's own residual against that bound, and |x - x64|_2 against
  |A^-1|_2 (bound + oracle's bound) |b|_2.  Returns the residual bound."""
  b_norm = norm64(b64)
  rel = norm64(b64 - matvec64(a64, x)) / b_norm
  bound = spl._residual_bound(rtol, iters, a_norm, inv_norm * b_norm, b_norm)
  line = (f"  {label}: |b - A x|_2 / |b|_2 {rel:.3g} <= {bound:.3g} (rtol "
          f"{rtol:g}, {iters} iterations, |A|_2 <= {a_norm:.4g}, |A^-1|_2 <= "
          f"{inv_norm:.4g}; float64 on the card)")
  ok = rel <= bound
  if oracle is not None:
    x64_host, bound64 = oracle
    x64 = torch.from_numpy(x64_host).to(b64.device)
    rel64 = norm64(b64 - matvec64(a64, x64)) / b_norm
    err = norm64(x.double() - x64)
    err_bound = inv_norm * (bound + bound64) * b_norm
    line += (f"; the float64 oracle's {rel64:.3g} <= {bound64:.3g}; "
             f"|x - x64|_2 {err:.3g} <= |A^-1|_2 (both bounds) |b|_2 = "
             f"{err_bound:.3g}")
    ok = ok and rel64 <= bound64 and err <= err_bound
  print(line)
  check(ok, f"{label}: x is past its residual or its oracle's bound")
  return bound


def heat_step_oracle(side: int, x0: np.ndarray) -> np.ndarray:
  """scipy's float64 cg of the heat step to HEAT_ORACLE_RTOL, started from
  the card's x (its own residual is held to its bound, so the start
  changes only how long it takes), run in a worker process (scipy's sparse
  products hold the interpreter lock, which a thread would take from the
  card's loop)."""
  a, u0 = heat_system(side)
  return ssl.cg(a, u0.astype(np.float64), x0=x0.astype(np.float64),
                rtol=HEAT_ORACLE_RTOL, maxiter=ORACLE_ITERS)[0]


def oracle_bound(rtol, a_norm, inv_norm) -> float:
  """The float64 true residual, relative to |b|, of a scipy solve whose
  stopping rule holds it to ``rtol`` |b|, within ORACLE_ITERS
  iterations."""
  return spl._residual_bound(rtol, ORACLE_ITERS, a_norm, inv_norm, 1.0,
                             eps=EPS64)


def solves_on_the_grid(device, procs):
  """cg on the heat step through K3b (its float64 oracle submitted to
  ``procs``), the same on 8 shards through K3d, bicgstab and gmres(20) on
  convection-diffusion through K3b."""
  with Timer() as t_build:
    heat, u0 = heat_system(GRID_SIDE)
    conv = convection_system(GRID_SIDE)
    S_heat = sparse.from_scipy(heat, dtype=np.float32)
    S_conv = sparse.from_scipy(conv, dtype=np.float32)
    b = sp.from_numpy(u0)
    b64 = torch.from_numpy(u0).to(device).double()
    heat64, conv64 = csr64(heat, device), csr64(conv, device)
    torch.cuda.synchronize()
  print(f"  built the {GRID_SIDE}^2 heat and convection-diffusion systems (n = "
        f"{heat.shape[0]}, {heat.nnz} and {conv.nnz} entries) and took them "
        f"in in {t_build.elapsed:.2f} s")
  fmt = sparse.spmv_expr(S_heat, sp.ones((heat.shape[0],),
                                         dtype=np.float32)).fmt
  check(fmt == "win", f"the heat system routed to {fmt!r}, not the CSR "
        "kernel")
  lin = sp.sparse.linalg
  out = {}

  def heat_cg(**limit):
    return lin.cg(S_heat, b, rtol=RTOL["cg"], **limit)

  x, res, iters, launches = counted_solve(f"heat step {GRID_SIDE}^2", "cg",
                                          heat_cg, "csr")
  check(res[0] == 0, "cg on the heat step did not converge")
  out["csr"] = launches
  out["heat"] = (heat, heat64, b64, x, iters)
  out["oracle"] = procs.submit(heat_step_oracle, GRID_SIDE, x.cpu().numpy())
  timing = {"heat cg": ("cg", heat_cg, iters, "spmv_csr")}
  mesh = sp.make_mesh(device, shape=(SOLVE_SHARDS,))
  with sp.with_mesh(mesh):
    x8, res8, iters8, launches8 = counted_solve(
        f"heat step on {SOLVE_SHARDS} shards", "cg", heat_cg, "sharded_csr")
  same = bool(torch.equal(x8, x)) and iters8 == iters
  print(f"  {SOLVE_SHARDS} shards through K3d: x and the iteration count "
        f"bit for bit the unsharded run's: {same}")
  check(same and res8 == res, "the sharded cg differs from the unsharded")
  out["sharded_csr"] = launches8
  del x8
  b_conv = sp.from_numpy(u0)
  xs = {}
  for name, kw in (("bicgstab", {}), ("gmres", {"restart": 20})):
    def solve(name=name, kw=kw, **limit):
      return getattr(lin, name)(S_conv, b_conv, rtol=RTOL[name], **kw,
                                **limit)

    xs[name], res, iters, launches = counted_solve(
        f"convection-diffusion {GRID_SIDE}^2", name, solve, "csr")
    check(res[0] == 0, f"{name} on convection-diffusion did not converge")
    out["csr"] += launches
    timing[f"convection {name}"] = (name, solve, iters, "spmv_csr")
    xs[name + " bound"] = hold_solve(
        f"convection {name}", conv64, xs[name], b64, RTOL[name], iters,
        norm2_bound(conv), 1.0)
  # margin 1 by rows and by columns: |A^-1|_2 <= 1
  gap = norm64(xs["bicgstab"].double() - xs["gmres"])
  bound = (xs["bicgstab bound"] + xs["gmres bound"]) * norm64(b64)
  print(f"  bicgstab and gmres agree: |x_b - x_g|_2 {gap:.3g} <= |A^-1|_2 "
        f"(both residual bounds) |b|_2 = {bound:.3g}")
  check(gap <= bound, "bicgstab and gmres disagree past their bounds")
  del conv64, xs
  return out, timing


def minres_oracle(a, w, b):
  """scipy's float64 minres to MINRES_ORACLE_RTOL, and A's smallest
  |eigenvalue|: min(4, |12 - rho2|) with rho2 W's second largest eigenvalue
  (W's largest is 16, the constant vector's)."""
  rho = ssl.eigsh(w, k=2, which="LA", return_eigenvectors=False)
  return (ssl.minres(a, b, rtol=MINRES_ORACLE_RTOL, maxiter=ORACLE_ITERS)[0],
          min(4.0, abs(REGULAR_SHIFT - float(rho.min()))))


def solves_at_32768(device):
  """cg on ``_sparse_spd`` and minres on the shifted Laplacian, both at
  n = 32768 through K3a, against scipy in float64."""
  rng = np.random.default_rng(191)
  spd = spd_system()
  indef, w = indefinite_system()
  b_spd = rng.standard_normal(SOLVE_N).astype(np.float32)
  b_ind = rng.standard_normal(SOLVE_N).astype(np.float32)
  lin = sp.sparse.linalg
  S_spd = sparse.from_scipy(spd, dtype=np.float32)
  S_ind = sparse.from_scipy(indef, dtype=np.float32)
  for S in (S_spd, S_ind):
    fmt = sparse.spmv_expr(S, sp.ones((SOLVE_N,), dtype=np.float32)).fmt
    check(fmt == "ell", f"a {SOLVE_N} system routed to {fmt!r}, not K3a")
  b1, b2 = sp.from_numpy(b_spd), sp.from_numpy(b_ind)

  def spd_cg(**limit):
    return lin.cg(S_spd, b1, rtol=RTOL["cg"], **limit)

  def ind_minres(**limit):
    return lin.minres(S_ind, b2, rtol=RTOL["minres"], **limit)

  x1, res1, it1, l1 = counted_solve(f"_sparse_spd {SOLVE_N}", "cg", spd_cg,
                                    "ell")
  x2, res2, it2, l2 = counted_solve(f"shifted Laplacian {SOLVE_N}", "minres",
                                    ind_minres, "ell")
  check(res1[0] == 0 and res2[0] == 0, "a solve at 32768 did not converge")
  # _sparse_spd: SPD with margin 1, so its eigenvalues are >= 1
  x64 = ssl.cg(spd, b_spd.astype(np.float64), rtol=ORACLE_RTOL,
               maxiter=ORACLE_ITERS)[0]
  a_norm = norm2_bound(spd)
  hold_solve(f"cg _sparse_spd {SOLVE_N}", csr64(spd, device), x1,
             torch.from_numpy(b_spd).to(device).double(), RTOL["cg"], it1,
             a_norm, 1.0, (x64, oracle_bound(ORACLE_RTOL, a_norm, 1.0)))
  # scipy's minres stops at |r| <= rtol (|A| |x| + |b|) with |A| its
  # estimate, the Frobenius norm of the Lanczos T_k: at most sqrt(3k) |A|_2
  m64, sigma = minres_oracle(indef, w, b_ind.astype(np.float64))
  a_norm = norm2_bound(indef)
  hold_solve(f"minres shifted Laplacian {SOLVE_N} (min|eig| {sigma:.4f})",
             csr64(indef, device), x2,
             torch.from_numpy(b_ind).to(device).double(), RTOL["minres"],
             it2, a_norm, 1.0 / sigma,
             (m64, oracle_bound(MINRES_ORACLE_RTOL * (
                 1.0 + (3 * ORACLE_ITERS) ** 0.5 * a_norm / sigma),
                 a_norm, 1.0 / sigma)))
  timing = {f"{SOLVE_N} cg": ("cg", spd_cg, it1, "spmv_ell"),
            f"{SOLVE_N} minres": ("minres", ind_minres, it2, "spmv_ell")}
  return l1 + l2, timing


def cgls64(a64, at64, b64, tol: float = 1e-10, maxiter: int = 1000):
  """The float64 least-squares oracle on the card: CGLS over torch's
  float64 sparse products (cuSPARSE), to |A'r| <= tol |A'b|; returns x,
  |b - A x| and its iterations."""
  x = torch.zeros(a64.shape[1], dtype=torch.float64, device=b64.device)
  r = b64.clone()
  s = matvec64(at64, r)
  p, g = s.clone(), float(s @ s)
  stop = tol ** 2 * g
  for k in range(1, maxiter + 1):
    q = matvec64(a64, p)
    alpha = g / float(q @ q)
    x += alpha * p
    r -= alpha * q
    s = matvec64(at64, r)
    g_new = float(s @ s)
    if g_new <= stop:
      break
    p = s + (g_new / g) * p
    g = g_new
  return x, norm64(b64 - matvec64(a64, x)), k


def least_squares(device):
  """lsqr and lsmr on the tall 2^22 x 2^20 system, A and A.T through K3b,
  held in float64 on the card to the normal-equations residual bound that
  their stopping rule, their iterations and |A|_2 fix, and to a float64
  CGLS's least-squares residual norm (scipy's lsqr of this system takes
  about a minute of the host)."""
  with Timer() as t_build:
    tall, b_host = tall_system(TALL_M, TALL_N, TALL_K)
    S = sparse.from_scipy(tall)
    b = sp.from_numpy(b_host)
    a64 = csr64(tall, device)
    at64 = csr64(tall.T.tocsr(), device)
    b64 = torch.from_numpy(b_host).to(device).double()
    atb = norm64(matvec64(at64, b64))
    torch.cuda.synchronize()
  a_norm, b_norm = norm2_bound(tall), norm64(b64)
  print(f"  built the tall system ({TALL_M} x {TALL_N}, {tall.nnz} entries, "
        f"|A|_2 <= {a_norm:.4g}) and took it in in {t_build.elapsed:.2f} s")
  with Timer() as t_oracle:
    x_opt, rnorm64, it64 = cgls64(a64, at64, b64)
  x_norm = norm64(x_opt)
  normal64 = norm64(matvec64(at64, b64 - matvec64(a64, x_opt))) / atb
  bound64 = spl._normal_bound(1e-10, it64, a_norm, x_norm, b_norm, atb,
                              eps=EPS64)
  print(f"  the float64 CGLS oracle: {it64} iterations in "
        f"{t_oracle.elapsed:.2f} s, |A'(b - A x)| / |A'b| {normal64:.3g} <= "
        f"{bound64:.3g}, |b - A x| {rnorm64:.8g}")
  check(normal64 <= bound64, "the float64 CGLS oracle did not converge")
  for M in (S, S.T):
    fmt = sparse.spmv_expr(M, sp.ones((M.shape[1],), dtype=np.float32)).fmt
    check(fmt == "win", f"the tall system routed to {fmt!r}, not K3b")
  lin = sp.sparse.linalg
  launches, timing = 0, {}
  for name in ("lsqr", "lsmr"):
    def solve(name=name, **limit):
      if name == "lsqr":
        return lin.lsqr(S, b, atol=LS_TOL, **limit)
      return lin.lsmr(S, b, atol=LS_TOL, btol=LS_TOL, **limit)

    x, res, iters, count = counted_solve(f"tall {TALL_M} x {TALL_N}", name,
                                         solve, "csr")
    launches += count
    timing[f"tall {name}"] = (name, solve, iters, "spmv_csr")
    # the stopping rules: lsqr |A'r| <= atol |A'b|; lsmr istop 2 |A'r| <=
    # atol |A| |r|, its |A| estimate after k steps at most sqrt(2k + 1)
    # |A|_2 and |r| <= |b|
    atol = LS_TOL if name == "lsqr" else (
        LS_TOL * (2 * iters + 1) ** 0.5 * a_norm * b_norm / atb)
    limit = spl._normal_bound(atol, iters, a_norm, x_norm, b_norm, atb)
    r = b64 - matvec64(a64, x)
    normal = norm64(matvec64(at64, r)) / atb
    rel = abs(norm64(r) - rnorm64) / rnorm64
    print(f"  {name}: istop {res[0]}, |A'(b - A x)| / |A'b| {normal:.3g} <= "
          f"{limit:.3g} (float64 on the card); |b - A x| {norm64(r):.8g} "
          f"against the oracle's optimum: {rel:.3g} (<= 1e-6: second order "
          "in x's error)")
    check(res[0] == (1 if name == "lsqr" else 2) and normal <= limit,
          f"{name} did not converge to its stated istop")
    check(rel <= 1e-6, f"{name}: the residual norm is not the optimum's")
  del x_opt
  return launches, timing


def loops_on_pagerank(device):
  """scan_iters over 50 PageRank steps on phase 6's 32768-node graph
  (K3a), its final carry against make_fori's bits and its collected
  change per step against the carries; cond on a predicate computed on
  the card, both ways.  Returns the scan's K3a launches."""
  n = PR_SMALL_N
  S = sparse.from_scipy(urand_graph(n, 2))

  def step(r):
    return sparse.spmv_expr(S, r) * DAMPING + (1.0 - DAMPING) / n

  r0 = sp.ones((n,), dtype=S.dtype) / n
  KS.reset_counts()
  with Timer() as t:
    final, deltas = sp.scan_iters(
        SCAN_STEPS, step, r0,
        collect=lambda r: sp.sum(sp.abs(step(r) - r)))
    torch.cuda.synchronize()
  launches = KS.counts["ell_launches"]
  check(launches == 2 * SCAN_STEPS and KS.counts["ell_plain_runs"] == 0,
        f"scan_iters launched K3a {launches} times, not {2 * SCAN_STEPS}")
  run = sp.make_fori(step, r0)
  same = bool(torch.equal(final.data, run(SCAN_STEPS).data))
  # the first step's change from make_fori's carries (the graph mixes
  # fast: the last steps' changes reach 0 in float32)
  first = float((run(1).data - sp.lazify(r0).evaluate().data
                 ).abs().double().sum())
  d = deltas.data
  rel = abs(float(d[0]) - first) / first
  print(f"  scan_iters: {SCAN_STEPS} steps in {t.elapsed:.3f} s ("
        f"{t.elapsed * 1e3 / SCAN_STEPS:.4f} ms a step, host), K3a "
        f"{launches} launches (the body's step and collect's), the final "
        f"carry bit for bit make_fori's: {same}; |r1 - r0|_1 "
        f"{float(d[0]):.6g} against {first:.6g} from make_fori's carries "
        f"({rel:.3g}); the change per step falls to {float(d[-1]):.4g}")
  check(same and d.shape == (SCAN_STEPS,) and rel <= 1e-9
        and bool(torch.isfinite(d).all()) and float(d[-1]) < float(d[0]),
        "scan_iters disagrees with make_fori")
  for limit, scale in ((0.5, 2.0), (1.5, 0.5)):
    got = sp.cond(sp.sum(final) > limit, lambda x: x * 2.0,
                  lambda x: x * 0.5, final)
    ok = bool(torch.equal(got.data, final.data * scale))
    print(f"  cond(sum(r) > {limit}) took the {'true' if scale == 2.0 else
          'false'} branch: {ok}")
    check(ok, "cond took the wrong branch")
  return launches


def phase_solvers(device, card: str) -> dict:
  """Phase 19: the loops and solvers at full size in float32; returns the
  SpMV launches of its counted runs by counts key.  scipy's float64 cg of
  the heat step runs in a worker process while the card works."""
  launches = {"ell": 0, "csr": 0, "sharded_csr": 0}
  t0 = time.perf_counter()

  def since(what: str) -> None:
    print(f"  [{time.perf_counter() - t0:.2f} s into phase 19: {what}]")

  with concurrent.futures.ProcessPoolExecutor(
      max_workers=1, mp_context=multiprocessing.get_context("spawn")) as procs:
    grid, timing = solves_on_the_grid(device, procs)
    launches["csr"] += grid["csr"]
    launches["sharded_csr"] += grid["sharded_csr"]
    since("the grid's solves done")
    ell, more = solves_at_32768(device)
    launches["ell"] += ell
    timing.update(more)
    since(f"the {SOLVE_N} solves done")
    csr, more = least_squares(device)
    launches["csr"] += csr
    timing.update(more)
    since("the least-squares solves done")
    launches["ell"] += loops_on_pagerank(device)
    heat, heat64, b64, x, iters = grid["heat"]
    x64 = grid["oracle"].result()
  since("the oracle's process ended")
  a_norm = norm2_bound(heat)
  hold_solve(f"cg heat step {GRID_SIDE}^2", heat64, x, b64, RTOL["cg"], iters,
             a_norm, 1.0, (x64, oracle_bound(HEAT_ORACLE_RTOL, a_norm, 1.0)))
  del grid, heat, heat64, x, x64
  print(f"  per iteration, on {card} (the oracle's process ended):")
  for label, (name, solve, iters, kernel) in timing.items():
    timed_solve(label, name, solve, iters, kernel)
  since("timed")
  torch.cuda.empty_cache()
  return launches



# phase 20: sp.sparse's builders, sp.linalg with the examples it wraps,
# sp.fft with Poisson's spectral solver, sp.random and array files
LAP_SIDE = 2048  # the 5-point Laplacian of a 2048^2 grid, n = 2^22: K3b
LAP_SMALL = (128, 256)  # n = 32768: K3a
LANCZOS_K = 6
LANCZOS_M = max(2 * LANCZOS_K + 8, 24)  # eigvalsh_lanczos's default m
SPRAND_N = 1 << 22
SPRAND_PER_ROW = 16
TALL = (1 << 20, 64)  # config 3's X
SSVD_K = 6
CHOL_N = 8192
DENSE_N = 4096
FFT_N = 16384  # config 1's shape
FFT_ORACLE_N = 4096
NORMAL_DRAWS = 1 << 28
DIST_DRAWS = 1 << 24
Z_BOUND = 6.0  # standard errors a sample moment may stray
EPS32 = 2.0 ** -24


def _agreed(label, got, want, tol, why):
  """The relative error of ``got`` to ``want`` (of max|want|), printed;
  fails past ``tol``."""
  got, want = np.asarray(got), np.asarray(want)
  err = float(np.abs(got.astype(want.dtype) - want).max()
              / max(float(np.abs(want).max()), 1e-300))
  print(f"  {label}: max err of max|oracle| {err:.3g} (tolerance {tol:g}: "
        f"{why})")
  check(got.shape == want.shape and bool(np.isfinite(got).all())
        and err <= tol, f"phase 20: {label} strays {err:.3g} > {tol:g}")
  return err


def _timed(label, fn, warm: bool = False):
  """``fn()`` evaluated once between CUDA events (device time with the
  host's gaps) and on the host clock; returns its result.  ``warm``: a
  first call before it, timed apart (a new FFT size builds its cuFFT
  plan; a factorization's first call in a process pays torch's first use
  of its solver)."""
  first = ""
  with Timer() as t:
    if warm:
      first_ms, out = events_ms(fn)
      del out
      first = f" (first call {first_ms:.3f} ms)"
    ms, out = events_ms(fn)
  print(f"  {label}: {ms:.3f} ms between events{first}, wall "
        f"{t.elapsed:.3f} s")
  HOST_SPANS["items"] = HOST_SPANS.get("items", 0.0) + t.elapsed
  return out


def kronsum_laplacian(nx: int, ny: int, dtype):
  """The 5-point Laplacian of an nx x ny grid through ``sp.sparse``:
  ``kronsum`` of two ``diags`` (a Dirichlet boundary)."""
  d = [-1.0, 2.0, -1.0]
  return sp.sparse.kronsum(
      sp.sparse.diags(d, [-1, 0, 1], shape=(nx, nx), dtype=dtype),
      sp.sparse.diags(d, [-1, 0, 1], shape=(ny, ny), dtype=dtype))


def grid_top_eigenvalues(nx: int, ny: int, k: int) -> np.ndarray:
  """The k largest eigenvalues of that Laplacian, closed form, ascending."""
  lx = 2 - 2 * np.cos(np.arange(1, nx + 1) * np.pi / (nx + 1))
  ly = 2 - 2 * np.cos(np.arange(1, ny + 1) * np.pi / (ny + 1))
  return np.sort((lx[:, None] + ly[None, :]).ravel())[-k:]


def _scipy_kronsum(nx: int, ny: int):
  d = [-1.0, 2.0, -1.0]
  return ss.kronsum(ss.diags(d, [-1, 0, 1], shape=(nx, nx)),
                    ss.diags(d, [-1, 0, 1], shape=(ny, ny))).tocsr()


def lanczos_on_grid(nx: int, ny: int, kernel: str, pool, card: str):
  """The float32 Laplacian of the nx x ny grid by ``sp.sparse.kronsum``,
  equal to scipy's; ``sp.linalg.eigvalsh_lanczos(L, k=6)`` with the SpMV
  counts set to 0 just before it (one ``kernel`` launch a Lanczos step,
  no plain run), within ``lanczos_tol`` of a float64 run on the card and
  at most the closed-form top 6 (Cauchy interlacing).  Returns the
  launches and the Laplacian."""
  n = nx * ny
  oracle = pool.submit(_scipy_kronsum, nx, ny)
  L = _timed(f"sp.sparse.kronsum of two diags, {nx} x {ny} grid (n = {n})",
             lambda: kronsum_laplacian(nx, ny, np.float32))
  with host_span("waiting for the oracles"):
    want = oracle.result()
  got = L.to_scipy()
  same = got.shape == want.shape and (got != want).nnz == 0
  print(f"  its CSR form equals scipy's kronsum: {same} ({got.nnz} entries, "
        f"ELL width {L.max_nnz_per_row}, nnz {L.nnz} with the two stored "
        "diagonals of a row)")
  check(same, f"kronsum Laplacian at {nx} x {ny} is not scipy's")
  KS.reset_counts()
  vals = _timed(f"sp.linalg.eigvalsh_lanczos(L, k={LANCZOS_K}) at n = {n}",
                lambda: sp.linalg.eigvalsh_lanczos(L, k=LANCZOS_K))
  launches = KS.counts[f"{kernel}_launches"]
  plain = KS.counts[f"{kernel}_plain_runs"]
  print(f"  {kernel} launches {launches} (one a step of {LANCZOS_M}), plain "
        f"runs {plain}")
  check(launches == LANCZOS_M and plain == 0,
        f"Lanczos at n = {n}: {launches} {kernel} launches, {plain} plain")
  vals64 = sp.linalg.eigvalsh_lanczos(L.astype(np.float64), k=LANCZOS_K)
  top = grid_top_eigenvalues(nx, ny, LANCZOS_K)
  slack = lanczos.lanczos_tol(LANCZOS_M, 8.0)
  dev = float(np.abs(vals - vals64).max())
  below = bool((vals <= top + slack).all() and (vals64 <= top + 1e-12).all())
  print(f"  Ritz values {np.array2string(vals, precision=6)}; float64 run "
        f"{np.array2string(vals64, precision=6)}: apart {dev:.3g} "
        f"(tolerance {slack:.3g}, lanczos_tol); closed-form top "
        f"{np.array2string(top, precision=6)}: each at most its eigenvalue "
        f"{below}, the top one {top[-1] - vals[-1]:.3g} below")
  check(dev <= slack and below, f"Lanczos at n = {n} disagrees")
  held_against_plain(L, kernel)
  return launches, L


def held_against_plain(L, kernel: str) -> None:
  """After the counted run: ``kernel``'s wrapper on the operands the
  Lanczos run gave it (L's CSR form for K3b, its ELL for K3a) and a seeded
  x, against its plain version on the same inputs."""
  x = torch.randn(L.shape[1], generator=torch.Generator(L.cols.device)
                  .manual_seed(21), device=L.cols.device)
  if kernel == "csr":
    ops = L.to_csr()
    got, want = KS.spmv_csr(*ops, x), KS.spmv_csr_plain(*ops, x)
  else:
    got = KS.spmv_ell(L.cols, L.vals, x)
    want = KS.spmv_ell_plain(L.cols, L.vals, x)
  err = float((got - want).abs().max() / want.abs().max())
  name = {"csr": "K3b spmv_csr", "ell": "K3a spmv_ell"}[kernel]
  print(f"  {name} on L ({L.shape[0]} rows) against its plain version: max "
        f"err of max|y| {err:.3g} (tolerance 1e-6: float32 sums of "
        f"{L.max_nnz_per_row} products in another order)")
  check(got.shape == want.shape and bool(torch.isfinite(got).all())
        and err <= 1e-6, f"{name} disagrees with its plain version on the "
        f"Laplacian at n = {L.shape[0]}")


def ell_csr_crossover(L, card: str) -> None:
  """K3b's wrapper on the n = 32768 Laplacian beside K3a's: the ELL/CSR
  crossover ``sparse.ONEHOT_MAX_M`` sets (no route changes here)."""
  x = torch.randn(L.shape[1], generator=torch.Generator(L.cols.device)
                  .manual_seed(20), device=L.cols.device)
  cols, vals = L.cols, L.vals
  indptr, indices, data = L.to_csr()
  y_ell = KS.spmv_ell(cols, vals, x)
  y_csr = KS.spmv_csr(indptr, indices, data, x)
  err = float((y_ell - y_csr).abs().max() / y_ell.abs().max())
  t = time_in_turns({"K3a spmv_ell": lambda: KS.spmv_ell(cols, vals, x),
                     "K3b spmv_csr": lambda: KS.spmv_csr(indptr, indices,
                                                         data, x)})
  nbytes = indptr.numel() * 8 + indices.numel() * 4 + data.numel() * 4 + (
      2 * x.numel() * 4)
  bound_ms, _ = bound(nbytes, 2 * indices.numel())
  print(f"  ELL/CSR crossover at n = {L.shape[0]} on {card}: K3a "
        f"{t['K3a spmv_ell']:.4f} ms (width {cols.shape[1]}), K3b "
        f"{t['K3b spmv_csr']:.4f} ms (queued ahead "
        f"{t['K3a spmv_ell ahead']}/{t['K3b spmv_csr ahead']}); the CSR "
        f"form's byte bound {bound_ms:.4f} ms; results apart {err:.2g}")
  check(err <= 1e-6, "K3a and K3b disagree on the Laplacian")


def sparse_random_item(card: str) -> int:
  """``sp.sparse.random`` at 2^22 x 2^22, 16 entries a row: exactly
  round(density m n) distinct positions, values in [0, 1); its
  ``sp.sparse.linalg.norm`` one K1 launch against a float64 sum of
  squares.  Returns K1's launches."""
  density = SPRAND_PER_ROW / SPRAND_N
  with host_span("sparse.random (its host draw)"), Timer() as t:
    S = sp.sparse.random(SPRAND_N, SPRAND_N, density=density,
                         random_state=20, dtype=np.float32)
    torch.cuda.synchronize()
  want = int(round(density * SPRAND_N * SPRAND_N))
  indptr, indices, _ = S.to_csr()
  rows = torch.repeat_interleave(
      torch.arange(SPRAND_N, device=indptr.device), indptr[1:] - indptr[:-1],
      output_size=indices.numel())
  keys = rows * SPRAND_N + indices.long()
  distinct = int(keys.numel() - int((keys[1:] == keys[:-1]).sum()))
  increasing = bool((keys[1:] > keys[:-1]).all())
  # float32 values: NumPy's float64 draws in [0, 1) rounded, so 1.0 occurs
  in_range = bool(((S.vals >= 0) & (S.vals <= 1)).all())
  print(f"  sp.sparse.random({SPRAND_N}, {SPRAND_N}, density={density:.3g}) "
        f"in {t.elapsed:.2f} s: nnz {S.nnz}, stored {indices.numel()}, "
        f"distinct positions {distinct} (want {want}), sorted "
        f"{increasing}, values in [0, 1] {in_range}")
  check(S.nnz == indices.numel() == distinct == want and increasing
        and in_range, "sp.sparse.random broke its contract")
  del rows, keys
  K.reset_counts()
  got = _timed("sp.sparse.linalg.norm of its float32 values",
               lambda: float(spl.norm(S).glom()))
  launches, plain = K.counts["launches"], K.counts["plain_runs"]
  want_norm = float(torch.sqrt((S.vals.double() ** 2).sum()))
  rel = rel_err(got, want_norm)
  print(f"  norm {got!r} against a float64 sum of squares {want_norm!r}: "
        f"rel err {rel:.3g} (tolerance 1e-9: float32 squares summed in "
        f"float64, where a float32 sum of 2^26 would err by about 1e-7); "
        f"K1 launches {launches}, plain runs {plain}")
  check(launches == 1 and plain == 0 and rel <= 1e-9,
        "sp.sparse.linalg.norm did not take K1 or disagrees")
  return launches


def dense_linalg_items(device, pool, card: str) -> None:
  """sp.linalg at config 3's X (2^20 x 64 float64): lstsq, qr('tsqr'),
  svd_lowrank and pca.fit; cholesky at 8192^2 and solve('cholesky');
  eigh, svd, inv and slogdet at 4096^2 — each against NumPy's float64
  result on the pool's threads (their identities on the card)."""
  gen = torch.Generator(device).manual_seed(200)
  m, d = TALL
  X = torch.randn(m, d, generator=gen, dtype=torch.float64, device=device)
  y = torch.randn(m, generator=gen, dtype=torch.float64, device=device)
  # a decaying spectrum for the randomized SVD and PCA: 2^-j, floored
  scales = torch.clamp(0.5 ** torch.arange(d, dtype=torch.float64,
                                           device=device), min=1e-3)
  Xs = X * scales
  with host_span("fetches"):
    hX, hy, hXs = X.cpu().numpy(), y.cpu().numpy(), Xs.cpu().numpy()
  ls = pool.submit(lambda: np.linalg.lstsq(hX, hy, rcond=None)[0])
  sv = pool.submit(np.linalg.svd, hXs, False, False)
  cov = pool.submit(lambda: np.linalg.eigvalsh(
      np.cov(hXs, rowvar=False, bias=True))[::-1])
  w = _timed("sp.linalg.lstsq(X, y), 2^20 x 64",
             lambda: sp.evaluate(sp.linalg.lstsq(sp.Val(sp.SpartanArray(X)),
                                                 sp.Val(sp.SpartanArray(y)))))
  Q, R = _timed("sp.linalg.qr(X, method='tsqr')",
                lambda: sp.linalg.qr(sp.Val(sp.SpartanArray(X)),
                                     method="tsqr"))
  q, r = sp.evaluate(Q).data, sp.evaluate(R).data
  recon = float((q @ r - X).abs().max() / X.abs().max())
  orth = float((q.T @ q - torch.eye(d, dtype=q.dtype, device=device))
               .abs().max())
  print(f"  tsqr on the card: |QR - X| / max|X| {recon:.3g}, |Q'Q - I| "
        f"{orth:.3g} (tolerance 1e-12 each: CholeskyQR2 of a well "
        "conditioned X)")
  check(recon <= 1e-12 and orth <= 1e-12, "tsqr disagrees")
  _, s, _ = _timed(f"sp.linalg.svd_lowrank(Xs, k={SSVD_K})",
                   lambda: sp.linalg.svd_lowrank(sp.Val(sp.SpartanArray(Xs)),
                                                 k=SSVD_K))
  _, evals = _timed(f"pca.fit(Xs, k={SSVD_K})",
                    lambda: pca.fit(sp.Val(sp.SpartanArray(Xs)), k=SSVD_K))
  with host_span("waiting for the oracles"):
    want_w, want_s, want_ev = ls.result(), sv.result(), cov.result()
  _agreed("lstsq", w.data.cpu().numpy(), want_w, 1e-10,
          "normal equations of a kappa ~ 1 X in float64")
  _agreed("svd_lowrank's singular values", s, want_s[:SSVD_K], 1e-8,
          "20 subspace iterations at a gap of 0.5 a value")
  _agreed("pca.fit's eigenvalues", evals, want_ev[:SSVD_K], 1e-8,
          "30 subspace iterations at a gap of 0.25 a value")
  del X, y, Xs, w, Q, R, q, r, hX, hy, hXs
  # cholesky and solve('cholesky') at 8192^2
  n = CHOL_N
  M = torch.randn(n, n, generator=gen, dtype=torch.float64, device=device)
  A = M @ M.T + n * torch.eye(n, dtype=torch.float64, device=device)
  b = torch.randn(n, generator=gen, dtype=torch.float64, device=device)
  del M
  with host_span("fetches"):
    hA, hb = A.cpu().numpy(), b.cpu().numpy()
  chol = pool.submit(np.linalg.cholesky, hA)
  L = _timed(f"sp.linalg.cholesky at {n}^2 float64 (block 128)",
             lambda: sp.linalg.cholesky(sp.Val(sp.SpartanArray(A))))
  x = _timed("sp.linalg.solve(A, b, method='cholesky')",
             lambda: sp.evaluate(sp.linalg.solve(
                 sp.Val(sp.SpartanArray(A)), sp.Val(sp.SpartanArray(b)),
                 method="cholesky")))
  with host_span("waiting for the oracles"):
    want_L = chol.result()
  import scipy.linalg as sla
  with host_span("oracles"):
    want_x = sla.cho_solve((want_L, True), hb)
  _agreed("cholesky", L.data.cpu().numpy(), want_L, 1e-10,
          "kappa(A) about 5, float64")
  _agreed("solve(method='cholesky')", x.data.cpu().numpy(), want_x, 1e-10,
          "two blocked triangular solves, kappa about 5")
  del A, b, L, x, hA, want_L
  torch.cuda.empty_cache()
  # eigh, svd, inv, slogdet at 4096^2
  n = DENSE_N
  G = torch.randn(n, n, generator=gen, dtype=torch.float64, device=device)
  Sym = (G + G.T) / 2
  P = G @ G.T / n + torch.eye(n, dtype=torch.float64, device=device)
  with host_span("fetches"):
    hG, hS, hP = G.cpu().numpy(), Sym.cpu().numpy(), P.cpu().numpy()
  futs = {"eigvalsh": pool.submit(np.linalg.eigvalsh, hS),
          "svdvals": pool.submit(np.linalg.svd, hG, False, False),
          "inv": pool.submit(np.linalg.inv, hP),
          "slogdet": pool.submit(np.linalg.slogdet, hP)}
  w, v = _timed(f"sp.linalg.eigh at {n}^2 float64",
                lambda: sp.evaluate(list(sp.linalg.eigh(
                    sp.Val(sp.SpartanArray(Sym))))), warm=True)
  res = float((Sym @ v.data - v.data * w.data).abs().max()
              / w.data.abs().max())
  u, s, vt = _timed(f"sp.linalg.svd at {n}^2 float64",
                    lambda: sp.evaluate(list(sp.linalg.svd(
                        sp.Val(sp.SpartanArray(G))))), warm=True)
  rec = float(((u.data * s.data) @ vt.data - G).abs().max() / G.abs().max())
  Pi = _timed(f"sp.linalg.inv at {n}^2 float64",
              lambda: sp.linalg.inv(sp.Val(sp.SpartanArray(P))).evaluate(),
              warm=True)
  sign, logdet = _timed(f"sp.linalg.slogdet at {n}^2 float64",
                        lambda: sp.evaluate(list(sp.linalg.slogdet(
                            sp.Val(sp.SpartanArray(P))))), warm=True)
  print(f"  eigh |A V - V W| / max|w| {res:.3g}, svd |U S Vt - G| / max|G| "
        f"{rec:.3g} (tolerance 1e-11 each: cuSOLVER's residual)")
  check(res <= 1e-11 and rec <= 1e-11, "eigh or svd residual too large")
  with host_span("waiting for the oracles"):
    want = {k: f.result() for k, f in futs.items()}
  _agreed("eigh's eigenvalues", w.data.cpu().numpy(), want["eigvalsh"],
          1e-10, "float64, both backward stable")
  _agreed("svd's singular values", s.data.cpu().numpy(), want["svdvals"],
          1e-10, "float64, both backward stable")
  _agreed("inv", Pi.data.cpu().numpy(), want["inv"], 1e-10,
          "kappa about 5, float64")
  ok = float(sign.glom()) == want["slogdet"][0]
  rel = rel_err(float(logdet.glom()), want["slogdet"][1])
  print(f"  slogdet sign equal {ok}, logdet rel err {rel:.3g} (tolerance "
        "1e-12)")
  check(ok and rel <= 1e-12, "slogdet disagrees")
  del G, Sym, P, w, v, u, s, vt, Pi, hG, hS, hP, want
  torch.cuda.empty_cache()


def _free_fft() -> None:
  torch.backends.cuda.cufft_plan_cache.clear()
  torch.cuda.empty_cache()


def fft_items(device, pool, card: str) -> None:
  """sp.fft at config 1's 16384^2 float32: fft2/ifft2 and rfft2/irfft2
  round trips and Parseval's identity on the card; NumPy's float64 FFT as
  the oracle at 4096^2; Poisson's spectral solve at 16384^2 by its own
  residual through ``laplacian``, and against NumPy at 4096^2."""
  gen = torch.Generator(device).manual_seed(201)
  n = FFT_N
  x = torch.randn(n, n, generator=gen, dtype=torch.float32, device=device)
  X = sp.Val(sp.SpartanArray(x))
  # a float32 FFT of N points errs by about log2(N) roundings of the
  # largest coefficient; 8 of them of slack
  tol = 8 * np.log2(n * n) * EPS32
  F = _timed(f"sp.fft.fft2 at {n}^2 float32",
             lambda: sp.fft.fft2(X).evaluate(), warm=True)
  check(F.dtype == torch.complex64, f"fft2 of float32 gave {F.dtype}")
  energy = float((F.data.abs().double() ** 2).sum()) / (n * n)
  direct = float((x.double() ** 2).sum())
  parseval = rel_err(energy, direct)
  back = _timed("sp.fft.ifft2 of it", lambda: sp.fft.ifft2(sp.Val(F))
                .evaluate(), warm=True)
  trip = float((back.data.real - x).abs().max() / x.abs().max())
  del F, back
  _free_fft()
  R = _timed(f"sp.fft.rfft2 at {n}^2 float32",
             lambda: sp.fft.rfft2(X).evaluate(), warm=True)
  back = _timed("sp.fft.irfft2 of it", lambda: sp.fft.irfft2(
      sp.Val(R), s=(n, n)).evaluate(), warm=True)
  rtrip = float((back.data - x).abs().max() / x.abs().max())
  print(f"  Parseval: sum|F|^2 / N against sum|x|^2 rel err {parseval:.3g}; "
        f"round trips |ifft2(fft2 x) - x| {trip:.3g}, |irfft2(rfft2 x) - x| "
        f"{rtrip:.3g} of max|x| (tolerance {tol:.3g}: 8 log2 N float32 "
        "roundings)")
  check(max(parseval, trip, rtrip) <= tol, "an FFT round trip disagrees")
  del R, back, X, x
  _free_fft()
  # NumPy's FFT at 4096^2
  m = FFT_ORACLE_N
  h = np.random.default_rng(202).standard_normal((m, m), dtype=np.float32)
  oracle = pool.submit(np.fft.fft2, h.astype(np.float64))
  roracle = pool.submit(np.fft.rfft2, h.astype(np.float64))
  H = sp.from_numpy(h)
  got = sp.fft.fft2(H).glom()
  rgot = sp.fft.rfft2(H).glom()
  tol_m = 8 * np.log2(m * m) * EPS32
  with host_span("waiting for the oracles"):
    want, rwant = oracle.result(), roracle.result()
  _agreed(f"fft2 at {m}^2 against NumPy's float64", got, want, tol_m,
          "8 log2 N float32 roundings")
  _agreed(f"rfft2 at {m}^2 against NumPy's float64", rgot, rwant, tol_m,
          "8 log2 N float32 roundings")
  del got, rgot, want, rwant
  _free_fft()
  # Poisson's spectral solve at 16384^2
  f = torch.randn(n, n, generator=gen, dtype=torch.float64, device=device)
  f = (f - f.mean()).to(torch.float32)
  Fv = sp.Val(sp.SpartanArray(f))
  u = _timed(f"poisson.solve at {n}^2 (float32 f)",
             lambda: poisson.solve(Fv).evaluate(), warm=True)
  _free_fft()
  res = float(sp.max(sp.abs(poisson.laplacian(sp.Val(u)) - Fv)).glom())
  ptol = 64 * np.log2(n * n) * EPS32 * float(f.abs().max())
  print(f"  its residual max|laplacian(u) - f| {res:.3g} (tolerance "
        f"{ptol:.3g}: the complex64 forward transform's roundings, 64 "
        "log2 N of max|f|)")
  check(res <= ptol, "the spectral Poisson solve's residual is too large")
  del f, Fv, u
  _free_fft()
  h = np.random.default_rng(203).standard_normal((m, m))
  h -= h.mean()

  def numpy_solve():
    k = 2.0 * np.pi * np.fft.fftfreq(m)
    lam = 2.0 * np.cos(k[:, None]) + 2.0 * np.cos(k[None, :]) - 4.0
    inv = np.where(lam == 0, 0.0, 1.0 / np.where(lam == 0, 1.0, lam))
    return np.real(np.fft.ifft2(np.fft.fft2(h) * inv))

  oracle = pool.submit(numpy_solve)
  got = poisson.solve(sp.from_numpy(h)).glom()
  with host_span("waiting for the oracles"):
    want = oracle.result()
  _agreed(f"poisson.solve at {m}^2 float64 against NumPy's", got, want,
          1e-12, "float64 FFTs, log2 N roundings amplified by 1/lambda")
  _free_fft()


def draw_items(device) -> None:
  """sp.random on the card: 2^28 standard normals and 2^24 draws each of
  gamma, beta, poisson and binomial, each held to its first two moments at
  Z_BOUND standard errors (the moments on the card in float64)."""
  cases = [("normal", lambda g: g.standard_normal(NORMAL_DRAWS), {}),
           ("gamma", lambda g: g.gamma(2.5, 1.5, size=DIST_DRAWS),
            {"shape": 2.5, "scale": 1.5}),
           ("gamma", lambda g: g.gamma(0.3, size=DIST_DRAWS),
            {"shape": 0.3}),
           ("beta", lambda g: g.beta(0.5, 2.0, size=DIST_DRAWS),
            {"a": 0.5, "b": 2.0}),
           ("poisson", lambda g: g.poisson(3.0, size=DIST_DRAWS),
            {"lam": 3.0}),
           ("binomial", lambda g: g.binomial(10, 0.3, size=DIST_DRAWS),
            {"n": 10, "p": 0.3})]
  for i, (op, draw, params) in enumerate(cases):
    t = _timed(f"sp.random {op}{tuple(params.values())}",
               lambda: draw(sp.random.default_rng(2000 + i)).evaluate()).data
    check(t.device == device, f"{op} drew off the card")
    x = t.double()
    k = x.numel()
    mean, var, mu4 = sp.random.moments(op, **params)
    zm = abs(float(x.mean()) - mean) / np.sqrt(var / k)
    zv = abs(float(x.var(correction=0)) - var) / np.sqrt((mu4 - var * var)
                                                         / k)
    print(f"    {k} draws, {t.dtype}: mean z {zm:.2f}, variance z {zv:.2f} "
          f"(bound {Z_BOUND})")
    check(zm < Z_BOUND and zv < Z_BOUND, f"{op} draws miss their moments")
    del t, x
  torch.cuda.empty_cache()


def file_items(device) -> None:
  """Array files on the card: ``save``/``load`` of a 16384^2 float32 array
  (1 GiB) bit for bit, a ``checkpoint`` inside a DAG and its restore, and
  ``from_file`` of a ``.npy`` file."""
  import tempfile
  gen = torch.Generator(device).manual_seed(204)
  x = torch.randn(FFT_N, FFT_N, generator=gen, device=device)
  B = sp.Val(sp.SpartanArray(x))
  with tempfile.TemporaryDirectory() as tmp:
    with host_span("files"), Timer() as t_save:
      sp.save(B, f"{tmp}/b")
    with host_span("files"), Timer() as t_load:
      back = sp.load(f"{tmp}/b")
      torch.cuda.synchronize()
    same = bool(torch.equal(back.data, x))
    print(f"  sp.save of {x.numel() * 4 / 2 ** 30:.2f} GiB in "
          f"{t_save.elapsed:.2f} s, sp.load in {t_load.elapsed:.2f} s (warm "
          f"page cache): bit for bit {same}")
    check(same and back.data.device == device, "save/load changed the bits")
    del back
    with host_span("files"):
      total = float((sp.checkpoint(B * 2.0, f"{tmp}/ck") + 1.0).sum().glom())
      again = sp.checkpoint(sp.zeros(x.shape, dtype=np.float32),
                            f"{tmp}/ck").evaluate()
    want = float((x.double() * 2.0 + 1.0).sum())
    restored = bool(torch.equal(again.data, x * 2.0))
    print(f"  checkpoint in a DAG: (ck + 1).sum() rel err "
          f"{rel_err(total, want):.3g} (tolerance 1e-9: float64 sums); a "
          f"fresh expr over its path restores it bit for bit {restored}")
    check(rel_err(total, want) <= 1e-9 and restored,
          "the checkpoint path disagrees")
    del again
    small = x[:FFT_ORACLE_N].cpu().numpy()
    np.save(f"{tmp}/x.npy", small)
    got = sp.from_file(f"{tmp}/x.npy").evaluate()
    ok = bool(torch.equal(got.data.cpu(), torch.from_numpy(small)))
    print(f"  sp.from_file of a {small.nbytes / 2 ** 20:.0f} MiB .npy: bit "
          f"for bit {ok}")
    check(ok, "from_file changed the bits")
  del x, B
  torch.cuda.empty_cache()


def phase_namespaces(device, card: str) -> dict:
  """Phase 20: sp.sparse's builders, sp.linalg, sp.fft with Poisson's
  spectral solver, sp.random and array files at full size.  Returns the
  launches of its counted runs: K3b and K3a by Lanczos, K1 by
  ``sp.sparse.linalg.norm``."""
  pool = concurrent.futures.ThreadPoolExecutor(max_workers=6)
  with pool:
    csr, _ = lanczos_on_grid(LAP_SIDE, LAP_SIDE, "csr", pool, card)
    gc.collect()
    torch.cuda.empty_cache()
    ell, small = lanczos_on_grid(*LAP_SMALL, "ell", pool, card)
    ell_csr_crossover(small, card)
    del small
    k1 = sparse_random_item(card)
    gc.collect()
    torch.cuda.empty_cache()
    dense_linalg_items(device, pool, card)
    fft_items(device, pool, card)
  draw_items(device)
  file_items(device)
  return {"csr": csr, "ell": ell, "k1": k1}


# phase 21: the spectral solvers of sp.sparse.linalg on the SpMV kernels,
# LaplacianNd, the densified and host functions, and sp.scipy_linalg
BIG_K, BIG_NCV, BIG_MAXITER = 6, 32, 20  # 2^22: a budget of 336 steps
SMALL_K, SMALL_NCV, SMALL_MAXITER = 6, 64, 120  # 128 x 256: converges
SI_SIGMA, SI_K, SI_NCV = 1e-3, 2, 6  # between the two lowest eigenvalues
CONV_UPWIND = 0.02  # eigs' operator L + c D_x: kappa(D) = 1.02^63.5
EIGS_K, EIGS_NCV, EIGS_MAXITER = 4, 40, 80
SVDS_K, SVDS_NCV = 10, 40  # ncv 21, svds's default, leaves the lowest
# of the 10 unconverged after 20 cycles (their gaps against the 11th)
EXPM_T = 1.0
LND_K, LND_NCV, LND_MAXITER = 4, 64, 150
SCIPY_N = 4096  # scipy_linalg's float64 items
SCIPY_ORACLE_N = 1024  # the same functions against scipy on the host
ORTH_RANK = 4000  # of SCIPY_N: the rank-deficient matrix's rank
GRID_FN = (64, 64)  # the densified functions' Laplacian: n = 4096
HOST_N = 48  # the host boundaries' matrices
F32_TOL = 1e-5  # eigsh/eigs's float32 residual tolerance of the scale
EPS64 = 2.0 ** -53


def grid_spectrum(nx: int, ny: int) -> np.ndarray:
  """Every eigenvalue of the nx x ny 5-point Laplacian, ascending."""
  lx = 2 - 2 * np.cos(np.arange(1, nx + 1) * np.pi / (nx + 1))
  ly = 2 - 2 * np.cos(np.arange(1, ny + 1) * np.pi / (ny + 1))
  return np.sort((lx[:, None] + ly[None, :]).ravel())


def ritz_checks(label, a64, spectrum, w, v, scale, converged: bool,
                distinct: bool):
  """The Ritz pairs ``(w, v)`` of a symmetric operator held to its closed-
  form ``spectrum`` (ascending), in float64 on the card: each vector's
  Rayleigh quotient rho and residual r = |A v - rho v| / |v|; Weyl's bound
  (an eigenvalue lies within r of rho, for any vector); Cauchy's
  interlacing for the k largest (the i-th largest Ritz value at most the
  i-th largest eigenvalue, up to the float32 rounding of the Ritz values,
  64 eps32 |A|); the Ritz values within that rounding of their vectors'
  Rayleigh quotients (a basis that lost its orthonormality breaks it);
  and, where the solve met its own tolerance, the largest
  Ritz value within it of the top eigenvalue and, for a spectrum whose top
  k are ``distinct`` (a rectangular grid), each within it of its own (a
  square grid's repeated eigenvalues give a Krylov space one vector of
  each, so a converged solve may hold a lower eigenvalue instead of a
  copy)."""
  V = v.data.double()
  AV = a64 @ V
  vv = (V * V).sum(0)
  rho = ((V * AV).sum(0) / vv).cpu().numpy()
  res = (torch.linalg.vector_norm(AV - V * torch.from_numpy(rho).to(
      V.device), dim=0) / vv.sqrt()).cpu().numpy()
  pos = np.clip(np.searchsorted(spectrum, rho), 1, len(spectrum) - 1)
  near = np.minimum(np.abs(spectrum[pos] - rho), np.abs(spectrum[pos - 1]
                                                        - rho))
  slack = 64 * EPS32 * scale
  weyl = bool((near <= res * (1 + 1e-9) + 1e-12 * scale).all())
  apart = float(np.abs(np.sort(w) - np.sort(rho)).max())
  top = spectrum[-len(w):]
  interlaced = bool((np.sort(w) <= top + slack).all())
  err = float(np.abs(np.sort(w) - top).max() if distinct
              else abs(float(np.max(w)) - float(top[-1])))
  at = "" if distinct else " at the top one"
  print(f"  {label}: Ritz values {np.array2string(np.sort(w), precision=7)}"
        f"; closed-form top {np.array2string(top, precision=7)} (apart "
        f"{err:.3g}{at}); residuals |Lv - rho v|/|v| in float64 "
        f"{np.array2string(res, precision=3)}; |w - rho| {apart:.3g} "
        f"(tolerance {slack:.3g}); Weyl (an eigenvalue within r of rho) "
        f"{weyl}; interlacing (<= top + {slack:.3g}) {interlaced}")
  check(weyl and interlaced and apart <= slack,
        f"{label}: the Ritz values stray from their vectors' Rayleigh "
        "quotients, or break Weyl's bound or the interlacing")
  if converged:
    tol = F32_TOL * scale + slack
    check(err <= tol and float(res.max()) <= tol,
          f"{label}: converged, yet {err:.3g} from the closed form or a "
          f"residual {float(res.max()):.3g} past {tol:.3g}")


def counted_eigsh(label, kernel, call):
  """``call()`` with the SpMV counts set to 0 just before it: one
  ``kernel`` launch an Arnoldi step, no plain run; returns its result,
  launches and cycles."""
  KS.reset_counts()
  with Timer() as t:
    out = call()
    torch.cuda.synchronize()
  st = dict(spl.stats)
  launches = KS.counts[f"{kernel}_launches"]
  plain = KS.counts["ell_plain_runs"] + KS.counts["csr_plain_runs"]
  print(f"  {label}: {st['cycles']} restart cycles, {st['steps']} Arnoldi "
        f"steps, fused {st['fused']}; {kernel} launches {launches} (one a "
        f"step), plain runs {plain}; {t.elapsed:.3f} s")
  check(launches == st["steps"] > 0 and plain == 0,
        f"{label}: {launches} {kernel} launches, {plain} plain runs for "
        f"{st['steps']} steps")
  HOST_SPANS["items"] = HOST_SPANS.get("items", 0.0) + t.elapsed
  return out, launches, st["cycles"]


def cycle_times(label, solve, card: str):
  """Host and device ms a steady restart cycle: ``solve(c)`` runs c
  cycles (the counted call built the step, whatever c); each of 1 and 3
  cycles is called once on the host clock and once under torch.profiler,
  and the two are differenced over the 2 cycles between them (which takes
  out the set-up and the first cycle's longer run of steps).  Short
  profiles: the profiler's post-processing grows with the ops it
  recorded."""
  walls, devs = [], []
  for c in (1, 3):
    with Timer() as t:
      solve(c)
      torch.cuda.synchronize()
    walls.append(t.elapsed * 1e3)
    devs.append(device_share(lambda: solve(c))[1])
  host = (walls[1] - walls[0]) / 2
  if None in devs:
    print(f"  {label} on {card}: host {host:.3f} ms a cycle; device time "
          "not measured")
    return
  dev = (devs[1] - devs[0]) / 2
  print(f"  {label} on {card}: host {host:.3f} ms, device {dev:.3f} ms a "
        f"steady cycle (3 cycles less 1, host clock and torch.profiler), "
        f"1 - device / host {1 - dev / host:.3f}")


def eigsh_on_grids(device, pool, card: str) -> dict:
  """eigsh on the float32 Laplacians of the 2048^2 grid (K3b) and of the
  128 x 256 grid (K3a, plain and by shift-invert with minres inside),
  against the closed form.  Returns the launches."""
  oracle_big = pool.submit(_scipy_kronsum, LAP_SIDE, LAP_SIDE)
  Lb = kronsum_laplacian(LAP_SIDE, LAP_SIDE, np.float32)
  spec_big = grid_spectrum(LAP_SIDE, LAP_SIDE)

  def big(maxiter=BIG_MAXITER):
    return spl.eigsh(Lb, k=BIG_K, which="LA", ncv=BIG_NCV, maxiter=maxiter)

  (w, v), csr, cycles = counted_eigsh(
      f"eigsh(L, k={BIG_K}, 'LA', ncv={BIG_NCV}, maxiter={BIG_MAXITER}) "
      f"at n = {Lb.shape[0]}", "csr", big)
  with host_span("waiting for the oracles"):
    a64 = csr64(oracle_big.result(), device)
  ritz_checks("2^22 grid", a64, spec_big, w, v, 8.0,
              cycles < BIG_MAXITER, distinct=False)
  cycle_times("eigsh at 2^22", big, card)
  del a64, v
  nx, ny = LAP_SMALL
  Ls = kronsum_laplacian(nx, ny, np.float32)
  a64 = csr64(_scipy_kronsum(nx, ny), device)
  spec = grid_spectrum(nx, ny)

  def small(maxiter=SMALL_MAXITER):
    return spl.eigsh(Ls, k=SMALL_K, which="LA", ncv=SMALL_NCV,
                     maxiter=maxiter)

  (w, v), ell, cycles = counted_eigsh(
      f"eigsh(L, k={SMALL_K}, 'LA', ncv={SMALL_NCV}) at n = {nx * ny}",
      "ell", small)
  ritz_checks(f"{nx} x {ny} grid", a64, spec, w, v, 8.0,
              cycles < SMALL_MAXITER, distinct=True)
  check(cycles < SMALL_MAXITER, f"eigsh at n = {nx * ny} did not converge "
        f"in {SMALL_MAXITER} cycles")
  cycle_times(f"eigsh at {nx * ny}", small, card)
  # shift-invert: each matvec one minres solve of L - sigma I (n > 4096)
  KS.reset_counts()
  with spl._loops_run() as runs, Timer() as t:
    w, v = spl.eigsh(Ls, k=SI_K, sigma=SI_SIGMA, ncv=SI_NCV)
    torch.cuda.synchronize()
  HOST_SPANS["items"] = HOST_SPANS.get("items", 0.0) + t.elapsed
  inner = [spl._iterations("minres", c) for c, _ in runs]
  per, extra = spl._MATVECS["minres"]
  want = sum(per * i + extra for i in inner)
  si_ell = KS.counts["ell_launches"]
  plain = KS.counts["ell_plain_runs"] + KS.counts["csr_plain_runs"]
  nearest = np.sort(spec[np.argsort(np.abs(spec - SI_SIGMA))[:SI_K]])
  V = v.data.double()
  AV = a64 @ V
  res = (torch.linalg.vector_norm(AV - V * torch.from_numpy(w).to(device),
                                  dim=0)
         / torch.linalg.vector_norm(V, dim=0)).cpu().numpy()
  err = float(np.abs(w - nearest).max())
  tol = 16 * EPS32 * 8.0
  print(f"  eigsh(L, k={SI_K}, sigma={SI_SIGMA}, ncv={SI_NCV}) at n = "
        f"{nx * ny}: {len(inner)} minres solves of {min(inner)}-{max(inner)}"
        f" iterations ({sum(inner)} in all), K3a launches {si_ell} = the "
        f"solves' matvecs {want}, plain runs {plain}; {t.elapsed:.2f} s, "
        f"{t.elapsed * 1e3 / max(sum(inner), 1):.3f} ms a minres iteration;"
        f" eigenvalues {np.array2string(w, precision=8)} against the "
        f"closed form's nearest sigma {np.array2string(nearest, precision=8)}"
        f" (apart {err:.3g}, tolerance 16 eps32 |L| = {tol:.3g}); residuals "
        f"|L v - w v| / |v| {np.array2string(res, precision=3)} (the "
        f"float32 inner solves')")
  check(si_ell == want and plain == 0 and err <= tol,
        "shift-invert eigsh missed its launches or its eigenvalues")
  del a64, v, V, AV, Lb
  return {"csr": csr, "ell": ell + si_ell}


def convection_eigs(device, pool, card: str) -> int:
  """eigs on the float32 upwind convection-diffusion operator L + c D_x of
  the 128 x 256 grid (K3a a step) against its closed form (a similarity
  D = diag((1+c)^(i/2)) makes it symmetric: the 1-D spectra (2+c) -
  2 sqrt(1+c) cos and 2 - 2 cos summed) and scipy's ARPACK in float64 on
  the host.  Bauer-Fike: each Ritz value lies within kappa(D) r of an
  eigenvalue, r its residual.  Returns K3a's launches."""
  nx, ny = LAP_SMALL
  c = CONV_UPWIND
  dx = ss.diags([-1.0, 1.0], [-1, 0], shape=(nx, nx))
  C = (_scipy_kronsum(nx, ny)
       + c * ss.kronsum(dx, ss.csr_matrix((ny, ny)))).tocsr()
  arpack = pool.submit(lambda: ssl.eigs(C, k=EIGS_K, which="LM")[0])
  lx = (2 + c) - 2 * np.sqrt(1 + c) * np.cos(np.arange(1, nx + 1) * np.pi
                                              / (nx + 1))
  ly = 2 - 2 * np.cos(np.arange(1, ny + 1) * np.pi / (ny + 1))
  spec = np.sort((lx[:, None] + ly[None, :]).ravel())
  S = sparse.from_scipy(C.astype(np.float32))
  (w, v), ell, cycles, wall = counted_eigs(S)
  res = (np.linalg.norm(C @ v - v * w, axis=0)
         / np.linalg.norm(v, axis=0))  # float64, on the host (n = 32768)
  kappa = (1 + c) ** ((nx - 1) / 2)
  pos = np.clip(np.searchsorted(spec, w.real), 1, len(spec) - 1)
  near = np.minimum(np.abs(spec[pos] - w), np.abs(spec[pos - 1] - w))
  with host_span("waiting for the oracles"):
    ww = arpack.result()
  scale = float(np.abs(ww).max())
  apart = float(np.abs(np.sort(np.abs(w)) - np.sort(np.abs(ww))).max())
  tol = kappa * F32_TOL * scale + 64 * EPS32 * scale
  print(f"  eigs(C, k={EIGS_K}, 'LM', ncv={EIGS_NCV}) at n = {nx * ny}, "
        f"c = {c}: {cycles} Krylov-Schur cycles, K3a launches {ell}; "
        f"{wall:.2f} s; |w| {np.array2string(np.sort(np.abs(w)), precision=7)}"
        f" against ARPACK's {np.array2string(np.sort(np.abs(ww)), precision=7)}"
        f" (apart {apart:.3g}); residuals {np.array2string(res, precision=3)}"
        f"; nearest closed-form eigenvalue within kappa(D) r "
        f"({kappa:.3g} r): {bool((near <= kappa * res + 1e-12).all())}; "
        f"tolerance {tol:.3g} (kappa(D) tol scale + 64 eps32 scale)")
  check(bool((near <= kappa * res + 1e-12).all()) and apart <= tol
        and float(res.max()) <= F32_TOL * scale + 64 * EPS32 * scale,
        "eigs disagrees with the closed form or ARPACK")
  return ell


def counted_eigs(S):
  KS.reset_counts()
  with Timer() as t:
    out = spl.eigs(S, k=EIGS_K, which="LM", ncv=EIGS_NCV,
                   maxiter=EIGS_MAXITER)
    torch.cuda.synchronize()
  HOST_SPANS["items"] = HOST_SPANS.get("items", 0.0) + t.elapsed
  st = dict(spl.stats)
  launches = KS.counts["ell_launches"]
  plain = KS.counts["ell_plain_runs"] + KS.counts["csr_plain_runs"]
  check(launches == st["steps"] > 0 and plain == 0
        and st["cycles"] < EIGS_MAXITER,
        f"eigs: {launches} K3a launches, {plain} plain, {st}")
  return out, launches, st["cycles"], t.elapsed


def dst_heat(v: np.ndarray, side: int, t: float) -> np.ndarray:
  """exp(-t L) v for the side x side Dirichlet 5-point Laplacian, through
  its sine modes: scipy's orthonormal DST-I along both axes, float64."""
  from scipy.fft import dstn, idstn
  lam = 2 - 2 * np.cos(np.arange(1, side + 1) * np.pi / (side + 1))
  coef = dstn(v.reshape(side, side), type=1, norm="ortho")
  coef *= np.exp(-t * (lam[:, None] + lam[None, :]))
  return idstn(coef, type=1, norm="ortho").ravel()


def laplacian_items(device, pool, card: str) -> int:
  """expm_multiply of -L at 2^22 (K3b a step) against the sine modes;
  LaplacianNd's matvec at 2048^2 against -(L x) through K3b, eigsh on
  LaplacianNd((128, 256)) against its eigenvalues(), the periodic matvec
  timed.  Returns K3b's launches."""
  side = LAP_SIDE
  Lneg = kronsum_laplacian(side, side, np.float32) * -1.0
  x = np.random.default_rng(210).standard_normal(side * side).astype(
      np.float32)
  oracle = pool.submit(dst_heat, x.astype(np.float64), side, EXPM_T)
  KS.reset_counts()
  with Timer() as t:
    y = spl.expm_multiply(Lneg, x, t=EXPM_T)
    torch.cuda.synchronize()
  HOST_SPANS["items"] = HOST_SPANS.get("items", 0.0) + t.elapsed
  csr = KS.counts["csr_launches"]
  plain = KS.counts["csr_plain_runs"] + KS.counts["ell_plain_runs"]
  with host_span("waiting for the oracles"):
    want = oracle.result()
  err = float(np.abs(y.glom().astype(np.float64) - want).max()
              / np.abs(want).max())
  print(f"  expm_multiply(-L, x, t={EXPM_T}) at n = {side * side}: K3b "
        f"launches {csr} (ncv 30), plain runs {plain}; {t.elapsed:.3f} s; "
        f"max err of max|y| against the DST-I sine modes {err:.3g} "
        "(tolerance 1e-5: float32 Gram-Schmidt over 30 steps; the Krylov "
        "truncation at t |L| = 8 is below 1e-20)")
  check(csr == 30 and plain == 0 and err <= 1e-5,
        "expm_multiply missed its launches or the closed form")
  xt = torch.from_numpy(x).to(device)
  lnd = spl.LaplacianNd((side, side), boundary_conditions="dirichlet",
                        dtype=np.float32)
  KS.reset_counts()
  via_k3b = sp.dot(Lneg, sp.Val(sp.SpartanArray(xt))).evaluate().data
  csr += KS.counts["csr_launches"]
  got = lnd.matvec(sp.Val(sp.SpartanArray(xt))).evaluate().data
  ax = xt.abs().reshape(side, side)
  nb = 4 * ax
  nb[1:] += ax[:-1]
  nb[:-1] += ax[1:]
  nb[:, 1:] += ax[:, :-1]
  nb[:, :-1] += ax[:, 1:]
  diff = (got - via_k3b).abs().reshape(side, side)
  ok = bool((diff <= 8 * EPS32 * nb).all())
  print(f"  LaplacianNd(({side}, {side}), 'dirichlet') matvec against -(L x) "
        f"through K3b ({KS.counts['csr_launches']} launch): max |diff| "
        f"{float(diff.max()):.3g}, within 8 eps32 (|L| |x|) elementwise: "
        f"{ok}")
  check(ok and KS.counts["csr_launches"] == 1,
        "LaplacianNd's matvec disagrees with the kronsum Laplacian")
  per = spl.LaplacianNd((side, side), boundary_conditions="periodic",
                        dtype=np.float32)
  xv = sp.Val(sp.SpartanArray(xt))
  ms = time_in_turns({"periodic": lambda: per.matvec(xv).evaluate()})
  bound_ms, _ = bound(2 * xt.numel() * 4, 6 * xt.numel())
  print(f"  LaplacianNd(({side}, {side}), 'periodic') matvec on {card}: "
        f"{ms['periodic']:.4f} ms (two slices and a concatenate an axis "
        f"side; queued ahead {ms['periodic ahead']}), its byte bound "
        f"{bound_ms:.4f} ms")
  L = spl.LaplacianNd(LAP_SMALL, boundary_conditions="dirichlet")
  with Timer() as t:
    w, _ = spl.eigsh(L, k=LND_K, which="LA", ncv=LND_NCV,
                     maxiter=LND_MAXITER)
  HOST_SPANS["items"] = HOST_SPANS.get("items", 0.0) + t.elapsed
  err = float(np.abs(w - L.eigenvalues(LND_K)).max())
  print(f"  eigsh(LaplacianNd({LAP_SMALL}), k={LND_K}, 'LA', ncv={LND_NCV}) "
        f"in float64 (the operator's int8 dtype): {spl.stats['cycles']} "
        f"cycles, {t.elapsed:.2f} s; against eigenvalues() {err:.3g} "
        "(tolerance 1e-10: the solve's 1e-13 of the scale 8, times the "
        "top gap ratio)")
  check(err <= 1e-10, "eigsh on LaplacianNd disagrees with eigenvalues()")
  return csr


def draw_ratings(device, pool):
  """Phase 7's MovieLens-20M-shaped ratings (host CSR), and scipy's
  float64 svds of them submitted to the pool at once, so that the host
  computes it while the card runs the items before and after svds."""
  with Timer() as t_draw:
    R = movielens_shaped(device)
  print(f"  drew the ratings in {t_draw.elapsed:.2f} s; scipy's float64 "
        "svds of them started on the pool")
  R64 = R.astype(np.float64)
  return R, pool.submit(lambda: np.sort(
      ssl.svds(R64, k=SVDS_K, return_singular_vectors=False)))


def svds_on_ratings(device, R, card: str):
  """svds(R, k=10) of the ratings in float32: A x on K3a (26,744
  columns), A.T y on K3b (138,493), held by its residuals and
  orthonormality in float64 on the card; the ratings freed after.  Returns
  the launches and s, for :func:`hold_svds`."""
  print(f"  device memory allocated before the ratings: "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
  S = ingest_ratings(R)
  fmt_a = sparse._route(S, torch.float32, on_accel=True)[0]
  fmt_t = sparse._route(S.T, torch.float32, on_accel=True)[0]
  KS.reset_counts()
  with Timer() as t:
    u, s, vt = spl.svds(S, k=SVDS_K, ncv=SVDS_NCV)
    torch.cuda.synchronize()
  HOST_SPANS["items"] = HOST_SPANS.get("items", 0.0) + t.elapsed
  st = dict(spl.stats)
  ell, csr = KS.counts["ell_launches"], KS.counts["csr_launches"]
  plain = KS.counts["ell_plain_runs"] + KS.counts["csr_plain_runs"]
  print(f"  svds(R, k={SVDS_K}, ncv={SVDS_NCV}) of {S.shape[0]} x "
        f"{S.shape[1]} ({S.nnz} entries): A x on {fmt_a} (K3a), A.T y on "
        f"{fmt_t} (K3b); {st['cycles']} cycles, {st['steps']} Lanczos steps "
        f"on the Gram operator; K3a launches {ell} (a step, and {SVDS_K} "
        f"for u), K3b {csr} (a step), plain runs {plain}; {t.elapsed:.3f} s")
  check(fmt_a == "ell" and fmt_t == "win" and plain == 0
        and ell == st["steps"] + SVDS_K and csr == st["steps"],
        "svds did not put its products on K3a and K3b")
  a64 = csr64(R, device)
  U, V = u.data.double(), vt.data.double().T
  sv = torch.from_numpy(s).to(device)
  r1 = float(torch.linalg.vector_norm(a64 @ V - U * sv, dim=0).max())
  del a64
  at64 = csr64(R.T, device)
  r2 = float(torch.linalg.vector_norm(at64 @ U - V * sv, dim=0).max())
  del at64
  eye = torch.eye(SVDS_K, device=device, dtype=torch.float64)
  o1 = float((U.T @ U - eye).abs().max())
  o2 = float((V.T @ V - eye).abs().max())
  smax = float(s.max())
  print(f"  |A v - s u| / s_max {r1 / smax:.3g}, |A.T u - s v| / s_max "
        f"{r2 / smax:.3g} (tolerance tol s_max / s_min: the Gram "
        f"operator's float32 residual tolerance over s); orthonormality "
        f"{o1:.3g} (u), {o2:.3g} (v)")
  check(r1 / smax <= 1e-5
        and r2 / smax <= 2 * F32_TOL * smax / float(s.min())
        and max(o1, o2) <= 1e-4, "svds fails its residuals")
  del u, vt, U, V, S
  held = torch.cuda.memory_allocated()
  gc.collect()
  torch.cuda.empty_cache()
  print(f"  device memory allocated: {held / 1e9:.2f} GB once the ratings "
        f"are dropped, {torch.cuda.memory_allocated() / 1e9:.2f} GB after "
        "gc.collect()")
  return {"ell": ell, "csr": csr}, s


def hold_svds(s, oracle) -> None:
  """svds's singular values against scipy's float64 svds from the pool:
  within tol s_max^2 / s (the Gram eigenvalues' float32 residual
  tolerance, halved into s)."""
  with host_span("waiting for the oracles"):
    want = oracle.result()
  smax = float(s.max())
  tol = F32_TOL * smax ** 2 / s + 64 * EPS32 * smax
  apart = np.abs(s - want)
  print(f"  svds's s {np.array2string(s, precision=6)}; scipy's float64 "
        f"svds {np.array2string(want, precision=6)}: apart "
        f"{np.array2string(apart, precision=3)} (tolerance tol s_max^2 / s)")
  check(bool((apart <= tol).all()), "svds disagrees with scipy's")


def _rel_fro(a: torch.Tensor, b: torch.Tensor) -> float:
  return float(torch.linalg.matrix_norm(a - b) / torch.linalg.matrix_norm(b))


def scipy_linalg_items(device, pool, card: str) -> None:
  """sp.scipy_linalg at SCIPY_N^2 float64 on the card, each held by an
  identity; then at SCIPY_ORACLE_N^2 against scipy on the host; zero gate
  fallbacks on these inputs."""
  from spartan_tpu_torch import scipy_linalg as SL
  n = SCIPY_N
  gen = torch.Generator(device).manual_seed(211)
  M = torch.randn(n, n, generator=gen, dtype=torch.float64, device=device)
  Q, _ = torch.linalg.qr(torch.randn(n, n, generator=gen,
                                     dtype=torch.float64, device=device))
  lam = torch.linspace(1.0, 10.0, n, dtype=torch.float64, device=device)
  P = (Q * lam) @ Q.T
  P = (P + P.T) / 2
  Sym = (M + M.T) / (2 * n ** 0.5)

  def as_val(t):
    return sp.Val(sp.SpartanArray(t))

  w, V = torch.linalg.eigh(Sym)
  X = _timed(f"expm of a symmetric {n}^2", lambda: SL.expm(
      as_val(Sym)).evaluate())
  want = (V * torch.exp(w)) @ V.T
  e = _rel_fro(X.data, want)
  print(f"  expm against eigh's V e^w V^T: {e:.3g} (tolerance 1e-12)")
  check(e <= 1e-12, "expm disagrees with eigh's exponential")
  b = torch.randn(n, 2, generator=gen, dtype=torch.float64, device=device)
  lu_, piv = SL.lu_factor(as_val(M))
  x = _timed("lu_factor/lu_solve", lambda: SL.lu_solve((lu_, piv),
                                                        as_val(b)).evaluate())
  pv = piv.evaluate().data
  be = float(((M @ x.data - b).abs().max() / (M.abs().sum(1).max()
                                               * x.data.abs().max())))
  c = SL.cho_factor(as_val(P))
  xc = _timed("cho_factor/cho_solve", lambda: SL.cho_solve(
      c, as_val(b)).evaluate())
  bc = float(((P @ xc.data - b).abs().max() / (P.abs().sum(1).max()
                                               * xc.data.abs().max())))
  print(f"  backward errors |A x - b| / (|A| |x|): LU {be:.3g}, Cholesky "
        f"{bc:.3g} (tolerance n eps64 = {n * EPS64:.3g}); pivots 0-based in "
        f"[{int(pv.min())}, {int(pv.max())}]")
  check(be <= n * EPS64 and bc <= n * EPS64 and int(pv.min()) >= 0
        and int(pv.max()) < n, "lu/cho solves fail their backward errors")
  SL.reset_counts()
  Xs = _timed("sqrtm of a well-conditioned SPD", lambda: SL.sqrtm(
      as_val(P)).evaluate())
  es = _rel_fro(Xs.data @ Xs.data, P)
  Xl = _timed("logm", lambda: SL.logm(as_val(P)).evaluate())
  el = _rel_fro(torch.linalg.matrix_exp(Xl.data), P)
  lam_s = torch.where(torch.arange(n, device=device) % 2 == 0, lam, -lam)
  Ind = (Q * lam_s) @ Q.T
  Xg = _timed("signm of an indefinite symmetric", lambda: SL.signm(
      as_val((Ind + Ind.T) / 2)).evaluate())
  eg = _rel_fro(Xg.data, (Q * torch.sign(lam_s)) @ Q.T)
  print(f"  |X X - A| / |A| {es:.3g}, |expm(logm A) - A| / |A| {el:.3g}, "
        f"signm against Q sign(lambda) Q^T {eg:.3g} (tolerance 1e-10); gate "
        f"counts {SL.counts}")
  check(max(es, el, eg) <= 1e-10 and SL.counts == {
      "matfun_device": 3, "matfun_host_fallbacks": 0,
      "matfun_complex_host": 0}, "a matrix function failed or fell back")
  u, p = SL.polar(as_val(M))
  U = _timed("polar", lambda: u.evaluate())
  ep = _rel_fro(U.data @ p.evaluate().data, M)
  eo = float((U.data.T @ U.data - torch.eye(n, dtype=torch.float64,
                                             device=device)).abs().max())
  r = ORTH_RANK
  D = (torch.randn(n, r, generator=gen, dtype=torch.float64, device=device)
       @ torch.randn(r, n, generator=gen, dtype=torch.float64, device=device))
  O = _timed("orth of a rank-deficient matrix", lambda: SL.orth(
      as_val(D)).evaluate())
  N = _timed("null_space", lambda: SL.null_space(as_val(D)).evaluate())
  en = float((D @ N.data).abs().max() / D.abs().max())
  print(f"  polar: |u p - A| / |A| {ep:.3g}, |u^T u - I| {eo:.3g}; orth "
        f"{tuple(O.shape)}, null_space {tuple(N.shape)} of a rank-{r} "
        f"matrix, |A N| / max|A| {en:.3g} (tolerance 1e-10)")
  check(ep <= 1e-10 and eo <= 1e-10 and O.shape == (n, r)
        and N.shape == (n, n - r) and en <= 1e-10, "polar/orth/null_space")
  del M, Q, P, Sym, V, X, want, Xs, Xl, Xg, Ind, U, D, O, N, u, p
  torch.cuda.empty_cache()
  m = SCIPY_ORACLE_N
  rng = np.random.default_rng(212)
  A = rng.standard_normal((m, m)) / m ** 0.5
  Pm = A @ A.T + np.eye(m)
  import scipy.linalg as sla
  futures = {name: pool.submit(fn) for name, fn in (
      ("expm", lambda: sla.expm(A)), ("sqrtm", lambda: sla.sqrtm(Pm)),
      ("logm", lambda: sla.logm(Pm)), ("lu_factor", lambda: sla.lu_factor(A)),
      ("cosm", lambda: sla.cosm(A)))}
  got = {"expm": SL.expm(A), "sqrtm": SL.sqrtm(Pm), "logm": SL.logm(Pm),
         "cosm": SL.cosm(A)}
  for name, g in got.items():
    with host_span("waiting for the oracles"):
      ref = np.real(futures[name].result())
    err = float(np.abs(g.glom() - ref).max() / np.abs(ref).max())
    print(f"  {name} at {m}^2 against scipy on the host: {err:.3g} "
          "(tolerance 1e-10)")
    check(err <= 1e-10, f"{name} disagrees with scipy at {m}^2")
  lu_, piv = SL.lu_factor(A)
  wlu, wpiv = futures["lu_factor"].result()
  same = bool((piv.glom() == wpiv).all())
  e = float(np.abs(lu_.glom() - wlu).max() / np.abs(wlu).max())
  print(f"  lu_factor at {m}^2: pivots equal scipy's (0-based) {same}, "
        f"factors apart {e:.3g}")
  check(same and e <= 1e-10, "lu_factor disagrees with scipy")


def densified_items(device) -> None:
  """Sparse expm, inv and matrix_power of the 64 x 64 grid's float64
  Laplacian (n = 4096) densified on the card, and spsolve_triangular of
  its lower triangle, each against a dense identity on the card."""
  nx, ny = GRID_FN
  L = kronsum_laplacian(nx, ny, np.float64)
  Ld = L.dense_tensor()
  n = Ld.shape[0]
  w, V = torch.linalg.eigh(Ld)
  E = _timed(f"sparse_linalg.expm(-0.1 L) at n = {n}",
             lambda: spl.expm(L * -0.1).evaluate())
  e1 = _rel_fro(E.data, (V * torch.exp(-0.1 * w)) @ V.T)
  Li = _timed("sparse_linalg.inv(L)", lambda: spl.inv(L).evaluate())
  eye = torch.eye(n, dtype=torch.float64, device=device)
  e2 = float((Ld @ Li.data - eye).abs().max())
  P3 = _timed("sparse_linalg.matrix_power(L, 3)",
              lambda: spl.matrix_power(L, 3).evaluate())
  e3 = _rel_fro(P3.data, Ld @ Ld @ Ld)
  T = sparse.from_scipy(ss.tril(_scipy_kronsum(nx, ny)).tocsr())
  b = torch.randn(n, generator=torch.Generator(device).manual_seed(213),
                  dtype=torch.float64, device=device)
  xt = _timed("spsolve_triangular", lambda: spl.spsolve_triangular(
      T, sp.Val(sp.SpartanArray(b))).evaluate())
  e4 = float((T.dense_tensor() @ xt.data - b).abs().max() / b.abs().max())
  print(f"  expm against eigh {e1:.3g}, |L inv(L) - I| {e2:.3g}, L^3 "
        f"{e3:.3g}, triangular residual {e4:.3g} (tolerance 1e-10; cond(L) "
        f"{float(w.max() / w.min()):.3g})")
  check(max(e1, e2, e3, e4) <= 1e-10, "a densified function disagrees")


def host_boundary_items() -> None:
  """Each host boundary of both modules once at a small size: equal to
  scipy's own call on the same inputs and counted, one host run each."""
  import scipy.linalg as sla
  from spartan_tpu_torch import scipy_linalg as SL
  from spartan_tpu_torch.expr import fio
  rng = np.random.default_rng(214)
  n = HOST_N
  A = rng.standard_normal((n, n))
  B = rng.standard_normal((n, n))
  Pd = A @ A.T + n * np.eye(n)
  b = rng.standard_normal(n)
  band = np.vstack([np.r_[0, 0.5 * rng.standard_normal(n - 1)],
                    4 + rng.random(n)])
  ab3 = np.vstack([np.r_[0, rng.standard_normal(n - 1)],
                   6 + rng.random(n), np.r_[rng.standard_normal(n - 1), 0]])
  Q, Rq = np.linalg.qr(A)
  a4, b2 = A[:4, :4] - 3 * np.eye(4), A[:4, 4:6]
  Sp = ss.csr_matrix(Pd * (np.abs(Pd) > 1.0))
  S = sparse.from_scipy(Sp)
  c, r = A[:, 0], A[0, :]
  cases = [
      ("schur", lambda: SL.schur(A)[0], lambda: sla.schur(A)[0]),
      ("hessenberg", lambda: SL.hessenberg(A), lambda: sla.hessenberg(A)),
      ("funm", lambda: SL.funm(0.1 * A, np.exp),
       lambda: sla.funm(0.1 * A, np.exp)),
      ("solve_sylvester", lambda: SL.solve_sylvester(A, B, Pd),
       lambda: sla.solve_sylvester(A, B, Pd)),
      ("solve_continuous_lyapunov",
       lambda: SL.solve_continuous_lyapunov(A - n * np.eye(n), Pd),
       lambda: sla.solve_continuous_lyapunov(A - n * np.eye(n), Pd)),
      ("solve_discrete_lyapunov",
       lambda: SL.solve_discrete_lyapunov(A / (2 * n), Pd),
       lambda: sla.solve_discrete_lyapunov(A / (2 * n), Pd)),
      ("ldl", lambda: SL.ldl(Pd)[1], lambda: sla.ldl(Pd)[1]),
      ("solve_banded", lambda: SL.solve_banded((1, 1), ab3, b),
       lambda: sla.solve_banded((1, 1), ab3, b)),
      ("solveh_banded", lambda: SL.solveh_banded(band, b),
       lambda: sla.solveh_banded(band, b)),
      ("subspace_angles", lambda: SL.subspace_angles(A[:, :3], B[:, :3]),
       lambda: sla.subspace_angles(A[:, :3], B[:, :3])),
      ("matrix_balance", lambda: SL.matrix_balance(A)[0],
       lambda: sla.matrix_balance(A)[0]),
      ("qz", lambda: SL.qz(A, B)[0], lambda: sla.qz(A, B)[0]),
      ("eig_banded", lambda: SL.eig_banded(band)[0],
       lambda: sla.eig_banded(band)[0]),
      ("cholesky_banded", lambda: SL.cholesky_banded(band),
       lambda: sla.cholesky_banded(band)),
      ("solve_continuous_are",
       lambda: SL.solve_continuous_are(a4, b2, np.eye(4), np.eye(2)),
       lambda: sla.solve_continuous_are(a4, b2, np.eye(4), np.eye(2))),
      ("solve_discrete_are",
       lambda: SL.solve_discrete_are(0.1 * a4, b2, np.eye(4), np.eye(2)),
       lambda: sla.solve_discrete_are(0.1 * a4, b2, np.eye(4), np.eye(2))),
      ("solve_toeplitz", lambda: SL.solve_toeplitz((c + 3 * n, r), b),
       lambda: sla.solve_toeplitz((c + 3 * n, r), b)),
      ("expm_cond", lambda: SL.expm_cond(0.1 * A[:6, :6]),
       lambda: sla.expm_cond(0.1 * A[:6, :6])),
      ("qr_update", lambda: SL.qr_update(Q, Rq, b, b)[1],
       lambda: sla.qr_update(Q, Rq, b, b)[1]),
      ("splu", lambda: spl.splu(S).solve(b),
       lambda: ssl.splu(Sp.tocsc()).solve(b)),
      ("spilu", lambda: spl.spilu(S).solve(b),
       lambda: ssl.spilu(Sp.tocsc()).solve(b)),
      ("factorized", lambda: spl.factorized(S)(b),
       lambda: ssl.factorized(Sp.tocsc())(b)),
      # the estimator draws its sign vectors from NumPy's global stream
      ("onenormest", lambda: (np.random.seed(215), spl.onenormest(S))[1],
       lambda: (np.random.seed(215), ssl.onenormest(Sp))[1]),
      ("lgmres", lambda: spl.lgmres(S, b, rtol=1e-10)[0],
       lambda: ssl.lgmres(Sp, b, rtol=1e-10)[0]),
      ("gcrotmk", lambda: spl.gcrotmk(S, b, rtol=1e-10)[0],
       lambda: ssl.gcrotmk(Sp, b, rtol=1e-10)[0])]
  if hasattr(ssl, "funm_multiply_krylov"):
    cases.append(("funm_multiply_krylov",
                  lambda: spl.funm_multiply_krylov(sla.expm, S * 0.001, b),
                  lambda: ssl.funm_multiply_krylov(sla.expm, Sp * 0.001, b)))
  else:
    try:
      spl.funm_multiply_krylov(sla.expm, S, b)
      raise RuntimeError("funm_multiply_krylov ran without scipy's")
    except AttributeError as exc:
      print(f"  funm_multiply_krylov: this scipy lacks it; scipy's own "
            f"AttributeError ({exc})")
  worst = []
  with Timer() as t:
    for name, ours, theirs in cases:
      before = fio.counts["host_runs"]
      got = ours()
      got = np.asarray(got.glom() if hasattr(got, "glom") else got)
      runs = fio.counts["host_runs"] - before
      want = np.asarray(theirs())
      err = float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))
      worst.append((err, name))
      check(runs == 1 and err <= 1e-10,
            f"host boundary {name}: {runs} host runs, {err:.3g} from scipy")
  HOST_SPANS["items"] = HOST_SPANS.get("items", 0.0) + t.elapsed
  print(f"  {len(cases)} host boundaries at n = {n}, each one host run and "
        f"equal to scipy's own call (worst {max(worst)[0]:.3g}, "
        f"{max(worst)[1]}; tolerance 1e-10) in {t.elapsed:.2f} s")


def phase_spectral(device, card: str) -> dict:
  """Phase 21: the spectral solvers at full width through K3a/K3b,
  LaplacianNd, the densified and host functions, and sp.scipy_linalg at
  4096^2 float64.  Returns the counted launches of K3a and K3b, the host ratings and svds's
  singular values (for phase 24)."""
  pool = concurrent.futures.ThreadPoolExecutor(max_workers=6)
  with pool:
    launches = eigsh_on_grids(device, pool, card)
    gc.collect()
    torch.cuda.empty_cache()
    launches["ell"] += convection_eigs(device, pool, card)
    launches["csr"] += laplacian_items(device, pool, card)
    gc.collect()
    torch.cuda.empty_cache()
    R, oracle = draw_ratings(device, pool)
    rat, s = svds_on_ratings(device, R, card)
    launches["ell"] += rat["ell"]
    launches["csr"] += rat["csr"]
    scipy_linalg_items(device, pool, card)
    hold_svds(s, oracle)
  densified_items(device)
  host_boundary_items()
  # the host ratings (CSR, about 240 MB) and svds's values go on to phase 24
  return launches, R, s


# phase 22: autodiff (sp.compile, grad and its kin, minimize, sgd_train,
# remat) with convnet's training, and sp.sparse.csgraph
COMPILE_CALLS = 5
AD_SEED = 22  # config 3's X for the gradients and minimize
AD_L2 = 1e-3  # the reference test's logistic loss's ridge term
# scipy's BFGS oracle runs to this gradient: at its default 1e-5 the mean
# loss over 2^20 rows is so flat that it stopped 3.9e-8 above the optimum
# and 9.2e-4 from it in x, past the check's 5e-4 (on the H100's host)
ORACLE_GTOL = 1e-10
MNIST_CLASSES, CONVNET_EPOCHS, CONVNET_LR = 10, 3, 0.05
CSG_SOURCES = (0, 1 << 20, 2 << 20, (1 << 22) - 1)  # dijkstra's k = 4
CSG_WEIGHT_SEED = 23  # the urand graph's edge weights, from (0, 1]
CUT_SIDE = 1024  # the 5-point grid graph cut in two: O(diameter) rounds
FW_N, FW_DEGREE, FW_SAMPLES = 4096, 8, 64
LAP_PROBES = 2  # random vectors the Laplacians are held by


def config3_data(seed: int = AD_SEED):
  """(X, least-squares targets, logistic labels, w_true) at config 3's
  2^20 x 64 float64, drawn on the host from ``seed`` (the oracle workers
  draw the same)."""
  rng = np.random.default_rng(seed)
  X = rng.standard_normal((LINREG_N, LINREG_D))
  w_true = rng.standard_normal(LINREG_D)
  z = X @ w_true
  y = z + 0.01 * rng.standard_normal(LINREG_N)
  labels = (z + 0.3 * rng.standard_normal(LINREG_N) > 0).astype(np.float64)
  return X, y, labels, w_true


def logreg_bfgs_oracle(seed: int):
  """scipy's BFGS on the logistic loss of :func:`config3_data`, with its
  analytic gradient, to an infinity norm of the gradient below
  ORACLE_GTOL: (x, fun, nit, that norm), in a worker process."""
  import scipy.optimize as sopt
  X, _, y, _ = config3_data(seed)

  def fun(w):
    z = X @ w
    return (np.log1p(np.exp(-z)) + (1 - y) * z).mean() + AD_L2 * (w @ w)

  def jac(w):
    z = X @ w
    return X.T @ (1.0 / (1.0 + np.exp(-z)) - y) / X.shape[0] + 2 * AD_L2 * w

  res = sopt.minimize(fun, np.zeros(X.shape[1]), jac=jac, method="BFGS",
                      options={"gtol": ORACLE_GTOL})
  return res.x, float(res.fun), int(res.nit), float(np.abs(res.jac).max())


def urand_weights(nnz: int) -> np.ndarray:
  """The urand graph's edge weights, from (0, 1], in its canonical CSR
  order."""
  return 1.0 - np.random.default_rng(CSG_WEIGHT_SEED).random(nnz)


def urand_csgraph(weighted: bool):
  """The canonical float64 CSR of phase 6's urand 2^22 graph as
  sparse.from_scipy reads it, weighted by :func:`urand_weights` or not."""
  G = ss.csr_matrix(urand_graph(PR_BIG_N, 1), dtype=np.float64)
  G.sum_duplicates()
  if weighted:
    G.data = urand_weights(G.nnz)
  return G


def dijkstra_oracle(sources):
  """scipy's dijkstra on the weighted urand graph from each of
  ``sources`` (a worker process: scipy's graph searches hold the
  interpreter lock)."""
  import scipy.sparse.csgraph as cs
  return cs.dijkstra(urand_csgraph(True), indices=list(sources))


def bfs_oracle(sources):
  """Hop counts on the urand graph from each of ``sources`` by scipy's
  breadth-first tree: a vertex's count is its tree parent's plus one
  (a worker process)."""
  import scipy.sparse.csgraph as cs
  G = urand_csgraph(False)
  out = np.full((len(sources), G.shape[0]), np.inf)
  for row, src in zip(out, sources):
    order, pred = cs.breadth_first_order(G, src, return_predecessors=True)
    row[src] = 0.0
    for _ in range(G.shape[0]):  # one pass a level of the tree
      step = row[pred[order[1:]]] + 1.0
      if np.array_equal(step, row[order[1:]]):
        break
      row[order[1:]] = step
  return out


def structure_oracle(probes):
  """scipy's weak components of the urand graph, its normed Laplacian's
  diagonal and the Laplacian times each of ``probes`` (float64)."""
  import scipy.sparse.csgraph as cs
  G = urand_csgraph(False)
  n_comp, labels = cs.connected_components(G, directed=True,
                                           connection="weak")
  L, d = cs.laplacian(G, normed=True, return_diag=True)
  L = L.tocsr()
  return n_comp, labels, d, [L @ v for v in probes]


def submit_phase22_oracles(procs) -> dict:
  """Submit phase 22's host oracles to the worker processes ``procs``:
  scipy on the urand 2^22 graph (weighted and unweighted distances from
  CSG_SOURCES, weak components, the normed Laplacian) and scipy's BFGS.
  ``main`` submits them before the build, so that they run during phases
  1-21 (minutes of scipy on one core each)."""
  probes = [np.random.default_rng(28 + i).standard_normal(PR_BIG_N)
            for i in range(LAP_PROBES)]
  return {"weighted": procs.submit(dijkstra_oracle, CSG_SOURCES),
          "unweighted": procs.submit(bfs_oracle, CSG_SOURCES),
          "structure": procs.submit(structure_oracle, probes),
          "bfgs": procs.submit(logreg_bfgs_oracle, AD_SEED)}


def oracle_processes():
  """The two spawned worker processes the oracles of phases 6 and 22 run
  in."""
  return concurrent.futures.ProcessPoolExecutor(
      max_workers=2, mp_context=multiprocessing.get_context("spawn"))


def cut_grid_graph(side: int):
  """The 5-point grid graph of side^2 vertices (unit weights, both
  directions) without the edges between rows side/2 - 1 and side/2: two
  components, each of diameter 3 side / 2 - 2."""
  n = side * side
  idx = np.arange(n).reshape(side, side)
  right = (idx[:, :-1].ravel(), idx[:, 1:].ravel())
  keep = np.arange(side - 1) != side // 2 - 1
  down = (idx[:-1][keep].ravel(), idx[1:][keep].ravel())
  rows = np.concatenate([right[0], down[0], right[1], down[1]])
  cols = np.concatenate([right[1], down[1], right[0], down[0]])
  return ss.csr_matrix((np.ones(rows.shape[0]), (rows, cols)), shape=(n, n))


def fw_graph():
  """A random directed graph of FW_N vertices, FW_DEGREE out-edges a
  vertex with weights from (0, 1] (a repeated edge adds up)."""
  rng = np.random.default_rng(24)
  rows = np.repeat(np.arange(FW_N), FW_DEGREE)
  cols = rng.integers(0, FW_N, FW_N * FW_DEGREE)
  w = 1.0 - rng.random(FW_N * FW_DEGREE)
  keep = rows != cols
  G = ss.csr_matrix((w[keep], (rows[keep], cols[keep])), shape=(FW_N, FW_N))
  G.sum_duplicates()
  return G


ORACLE_WAIT = [0.0]  # seconds phase 22 waited for its oracle processes


def oracle_result(future):
  """``future.result()``, its wait added to ORACLE_WAIT."""
  t0 = time.perf_counter()
  out = future.result()
  ORACLE_WAIT[0] += time.perf_counter() - t0
  return out


def per_round(label, run, rounds_of):
  """Run ``run()`` once for its result and rounds, then once timed on the
  host (synced) and once under torch.profiler: prints the rounds and the
  host and device ms a round; returns the result."""
  out = run()
  rounds = rounds_of()
  torch.cuda.synchronize()
  with Timer() as t:
    run()
    torch.cuda.synchronize()
  _, dev_ms, _ = device_share(run)
  host = t.elapsed * 1e3 / max(rounds, 1)
  dev = ("not measured" if dev_ms is None
         else f"{dev_ms / max(rounds, 1):.4f} ms")
  print(f"  {label}: {rounds} rounds; host {host:.4f} ms a round (wall "
        f"{t.elapsed:.3f} s), device {dev} a round")
  return out


def _abs_sum64(blk) -> float:
  """sum(|1 + 2 v|) of a float32 block in float64 (NumPy, in place)."""
  y = blk.astype(np.float64)
  y *= 2
  y += 1
  return float(np.abs(y, out=y).sum())


def compile_items(device, card: str, k1_ms: float, pool):
  """sp.compile of config 1's sum(abs(1 + 2b)) (K1) on fresh b's; returns
  the launches counted over the calls and each call's result beside its
  NumPy float64 oracle, running on the threads of ``pool`` meanwhile
  (held by :func:`hold_compiled`)."""
  gen = torch.Generator(device=device).manual_seed(22)
  b0 = torch.randn(TIMED_SHAPE, generator=gen, device=device)
  b = sp.lazify(sp.SpartanArray(b0))
  f = sp.compile(sp.sum(sp.abs(1 + 2 * b)), wrt=[b])
  K.reset_counts()
  pending = []
  for _ in range(COMPILE_CALLS):
    fresh = torch.randn(TIMED_SHAPE, generator=gen, device=device)
    got = float(f(fresh).glom())
    blocks = np.array_split(fresh.cpu().numpy(), 64)
    pending.append((got, [pool.submit(_abs_sum64, blk) for blk in blocks]))
  launches = K.counts["launches"]
  plain = K.counts["plain_runs"] + K.counts["routed_plain"]
  ms, host, ahead = event_ms(lambda: f(b0))
  print(f"  sp.compile(sum(abs(1 + 2b)), wrt=[b]) at {TIMED_SHAPE[0]}^2 "
        f"float32: {COMPILE_CALLS} fresh b's, K1 launches {launches}, plain "
        f"runs {plain}; a call {ms:.4f} ms of device (host issue "
        f"{host:.4f} ms, queued ahead {ahead}) beside K1's {k1_ms:.4f} ms "
        f"(phase 2) on {card}")
  check(launches == COMPILE_CALLS and plain == 0,
        f"sp.compile launched K1 {launches} times ({K.counts})")
  return {"k1": launches}, pending


def hold_compiled(pending) -> None:
  """Each compiled sum against its NumPy float64 oracle."""
  worst = max(rel_err(got, sum(f.result() for f in blocks))
              for got, blocks in pending)
  print(f"  the {len(pending)} compiled sums against NumPy's float64: max "
        f"rel err {worst:.3g} (rtol 1e-6: float32 terms summed in float64)")
  check(worst <= 1e-6, "sp.compile's sum disagrees with NumPy")


def compiled_pagerank(S, want) -> int:
  """One PageRank step through sp.compile (wrt the rank), called PR_ITERS
  times from the uniform rank: held to phase 6's float64 ranks; returns
  K3b's launches over the calls."""
  n = S.shape[0]
  r = sp.from_numpy(np.full(n, 1.0 / n, dtype=np.float32))
  step = sp.compile(sparse.spmv_expr(S, r) * DAMPING + (1.0 - DAMPING) / n,
                    wrt=[r])
  KS.reset_counts()
  torch.cuda.synchronize()
  with Timer() as t:
    rank = torch.full((n,), 1.0 / n, dtype=torch.float32, device=S.cols.device)
    for _ in range(PR_ITERS):
      rank = step(rank).data
    got = rank.double().cpu().numpy()
  err = float(np.abs(got - want).max())
  launches, plain = KS.counts["csr_launches"], KS.counts["csr_plain_runs"]
  print(f"  sp.compile(PageRank step, wrt=[r]) on urand 2^22, {PR_ITERS} "
        f"calls: max|r - r64| {err:.3g} (<= 1e-5 max r64 = "
        f"{1e-5 * want.max():.3g}), K3b launches {launches}, plain runs "
        f"{plain}; {t.elapsed / PR_ITERS * 1e3:.4f} ms a call (host clock)")
  check(err <= 1e-5 * want.max(), "the compiled PageRank disagrees")
  check(launches == PR_ITERS and plain == 0,
        f"the compiled PageRank launched K3b {launches} times")
  return launches


def kernel_counts():
  return (K.counts["launches"], K.counts["plain_runs"], KS.counts["csr_launches"],
          KS.counts["ell_launches"], K5.counts["launches"])


def gradient_items(device, X_host, y_host):
  """grad, value_and_grad, hvp, hessian and jvp of sum((X w - y)^2)/n at
  config 3's shape against the hand forms on the card (float64)."""
  n, d = X_host.shape
  X, y = sp.from_numpy(X_host), sp.from_numpy(y_host)
  rng = np.random.default_rng(25)
  w_np, v_np = rng.standard_normal(d), rng.standard_normal(d)
  w = sp.from_numpy(w_np)
  loss = sp.sum((sp.dot(X, w) - y) ** 2) / n
  Xd, yd, wd, vd = (t.evaluate().data for t in (X, y, w, sp.from_numpy(v_np)))
  # the hand gradient of linear_reg.gradient_step
  hand = (2.0 / n) * (Xd.T @ (Xd @ wd - yd))
  hv_want = (2.0 / n) * (Xd.T @ (Xd @ vd))
  H_want = (2.0 / n) * (Xd.T @ Xd)
  before = kernel_counts()
  with Timer() as t:
    (g,) = sp.grad(loss, [w])
    val, (g2,) = sp.value_and_grad(loss, [w])
    (hv,) = sp.hvp(loss, [w], [v_np])
    H = sp.hessian(loss, [w])
    primal, tangent = sp.jvp(loss, [w], [v_np])
    torch.cuda.synchronize()
  moved = [a - b for a, b in zip(kernel_counts(), before)]

  def err(got, want):
    return float((got.data - want).abs().max() / want.abs().max())

  errs = {"grad": err(g, hand), "value_and_grad": err(g2, hand),
          "hvp": err(hv, hv_want), "hessian": err(H, H_want),
          "jvp": rel_err(float(tangent.glom()), float(hand @ vd)),
          "value": rel_err(float(val.glom()),
                           float(((Xd @ wd - yd) ** 2).sum() / n))}
  print(f"  grad, value_and_grad, hvp, hessian ({d} x {d}) and jvp of "
        f"sum((X w - y)^2)/n at {n} x {d} float64: relative errors "
        + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
        + f" (1e-10: float64 sums of {n} terms in another order); "
        f"{t.elapsed:.2f} s in all; kernel launches moved {moved}")
  check(max(errs.values()) <= 1e-10, f"a derivative disagrees ({errs})")
  check(not any(moved), f"a derivative moved a kernel's count ({moved})")


def sparse_gradient_items(device, S) -> int:
  """grad through SpMV on the urand 2^22 graph against A.T c (K3b on the
  transpose) and through SpMM at ML-20M's shape, k = 64, against
  2 R.T (R B) in float64 (cuSPARSE); returns K3b's launch for A.T c."""
  n = S.shape[0]
  gen = torch.Generator(device=device).manual_seed(26)
  x = sp.lazify(sp.SpartanArray(torch.randn(n, generator=gen, device=device)))
  c = torch.randn(n, generator=gen, device=device)
  before = kernel_counts()
  (g,) = sp.grad(sp.sum(sparse.spmv_expr(S, x) * sp.SpartanArray(c)), [x])
  moved = [a - b for a, b in zip(kernel_counts(), before)]
  KS.reset_counts()
  want = sparse.spmv(S.transpose(), c)
  launched = KS.counts["csr_launches"]
  e1 = float((g.data - want).abs().max() / want.abs().max())
  print(f"  grad of sum(spmv(A, x) * c) on urand 2^22 (fmt "
        f"{sparse.spmv_expr(S, x).fmt!r}): max|g - A.T c| / max|A.T c| "
        f"{e1:.3g} (1e-5: float32 sums of about 16 terms in another order; "
        f"A.T c by K3b, {launched} launch); launches moved {moved}")
  check(e1 <= 1e-5 and not any(moved) and launched == 1,
        "the SpMV gradient disagrees or moved a count")
  with Timer() as t_draw:
    R = movielens_shaped(device, seed=22)
    Sr = sparse.from_scipy(R, dtype=np.float32)
  B = torch.randn((ML_MOVIES, ALS_K), generator=gen, device=device)
  Bl = sp.lazify(sp.SpartanArray(B))
  before = kernel_counts()
  with Timer() as t_grad:
    (gB,) = sp.grad(sp.sum(sparse.spmm_expr(Sr, Bl) ** 2), [Bl])
    torch.cuda.synchronize()
  moved = [a - b for a, b in zip(kernel_counts(), before)]
  fmt = sparse.spmm_expr(Sr, Bl).fmt
  del Sr

  def csr64(m):
    return torch.sparse_csr_tensor(
        torch.from_numpy(m.indptr.astype(np.int64)),
        torch.from_numpy(m.indices.astype(np.int64)),
        torch.from_numpy(m.data.astype(np.float64)), m.shape).to(device)

  Y = csr64(R) @ B.double()
  want = 2 * (csr64(R.T.tocsr()) @ Y)
  e2 = float((gB.data.double() - want).abs().max() / want.abs().max())
  print(f"  grad of sum(spmm(R, B)^2) at ML-20M's shape, k = {ALS_K} (fmt "
        f"{fmt!r}): max|g - 2 R.T (R B)| / max {e2:.3g} (1e-4: float32 "
        f"products summed over up to {ML_MAX_USER} terms, squared); "
        f"grad {t_grad.elapsed:.2f} s, ratings drawn and ingested in "
        f"{t_draw.elapsed:.2f} s; launches moved {moved}")
  check(e2 <= 1e-4 and not any(moved),
        "the SpMM gradient disagrees or moved a count")
  del R, Y, want, gB
  return launched


def minimize_item(device, X_host, labels, oracle):
  """sp.minimize of the reference test's logistic loss at config 3's
  shape, held to scipy's BFGS (``oracle``, a worker's future)."""
  w = sp.from_numpy(np.zeros(X_host.shape[1]))
  z = sp.dot(sp.from_numpy(X_host), w)
  loss = sp.mean(sp.log1p(sp.exp(-z)) + (1.0 - sp.from_numpy(labels)) * z) \
      + AD_L2 * sp.sum(w * w)
  torch.cuda.synchronize()
  with Timer() as t:
    (w_opt,), info = sp.minimize(loss, [w])
    torch.cuda.synchronize()
  Xd = torch.from_numpy(X_host).to(device)
  wd = w_opt.data
  gfin = float((Xd.T @ (torch.sigmoid(Xd @ wd) - torch.from_numpy(
      labels).to(device)) / X_host.shape[0] + 2 * AD_L2 * wd).norm())
  del Xd
  x_ref, fun_ref, nit_ref, g_ref = oracle_result(oracle)
  err = float(np.abs(w_opt.glom() - x_ref).max())
  print(f"  sp.minimize (BFGS) of the logistic loss at {X_host.shape[0]} x "
        f"{X_host.shape[1]} float64: {info['nit']} iterations (scipy's BFGS "
        f"{nit_ref} to |grad|_inf {g_ref:.3g}), status {info['status']}, success {info['success']}, "
        f"wall {t.elapsed:.2f} s, final |grad|_2 "
        f"{gfin:.3g}; max|w - w_scipy| {err:.3g} (atol "
        f"5e-4), fun {info['fun']:.12g} vs scipy's {fun_ref:.12g} (<= + 1e-10)")
  check(info["success"] and err <= 5e-4 and info["fun"] <= fun_ref + 1e-10,
        "sp.minimize missed scipy's optimum")


def convnet_items(device, card: str):
  """convnet's training at MNIST's test-set shape: fit_fused and train,
  CONVNET_EPOCHS full-batch steps each, then sgd_train with remat around
  the first conv block; peak device memory with and without it."""
  rng = np.random.default_rng(27)
  images = rng.standard_normal(MNIST_SHAPE)
  labels = rng.integers(0, MNIST_CLASSES, MNIST_SHAPE[0])
  torch.cuda.synchronize()
  with Timer() as t_fused:
    _, losses_f = convnet.fit_fused(images, labels, MNIST_CLASSES,
                                    CONVNET_EPOCHS, CONVNET_LR)
  with Timer() as t_train:
    _, losses_e = convnet.train(images, labels, MNIST_CLASSES,
                                CONVNET_EPOCHS, CONVNET_LR)
  err = float(np.abs(np.asarray(losses_f) - losses_e).max()
              / np.abs(losses_e).max())
  onehot = np.eye(MNIST_CLASSES)[labels]
  params = convnet.init_params(n_classes=MNIST_CLASSES)
  peaks, curves = {}, {}
  for remat in (False, True):
    leaves = {k: sp.lazify(v) for k, v in params.items()}
    loss = convnet.loss_expr(sp.lazify(images), onehot, leaves,
                             remat_first=remat)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _, losses = sp.sgd_train(loss, list(leaves.values()), CONVNET_LR,
                             CONVNET_EPOCHS, collect_losses=True)
    curves[remat] = losses.glom()
    peaks[remat] = (torch.cuda.max_memory_allocated() - base) / 1e9
  err_remat = float(np.abs(curves[True] - curves[False]).max()
                    / np.abs(curves[False]).max())
  print(f"  convnet on {MNIST_SHAPE[0]} images of {MNIST_SHAPE[1:]}, "
        f"{MNIST_CLASSES} classes, {CONVNET_EPOCHS} full-batch steps: losses "
        f"{np.round(losses_f, 6).tolist()}; fit_fused vs train max rel "
        f"{err:.3g}, sgd_train with remat vs without {err_remat:.3g} (1e-10: "
        f"float64, cuDNN's convolution backward may sum in another order "
        f"from one call to the next); fit_fused "
        f"{t_fused.elapsed / CONVNET_EPOCHS * 1e3:.1f} ms a step, train "
        f"{t_train.elapsed / CONVNET_EPOCHS * 1e3:.1f} ms a step (host "
        f"clock, the first step's set-up in both); peak device memory above "
        f"the leaves {peaks[False]:.3f} GB without remat, {peaks[True]:.3f} "
        f"GB with it, on {card}")
  check(err <= 1e-10 and err_remat <= 1e-10 and losses_f[-1] < losses_f[0],
        "convnet's training curves disagree or do not fall")


def csgraph_items(device, S, oracles):
  """sp.sparse.csgraph at full width: dijkstra (unweighted and weighted)
  from CSG_SOURCES, weak components and the normed Laplacian of the urand
  2^22 graph against scipy (``oracles``: worker futures); components of
  the cut grid and Floyd-Warshall at FW_N against scipy on this host."""
  C = sp.sparse.csgraph
  k = len(CSG_SOURCES)
  dist = per_round(f"dijkstra unweighted, {k} sources, urand 2^22",
                   lambda: C.dijkstra(S, indices=list(CSG_SOURCES),
                                      unweighted=True),
                   lambda: CG.stats["rounds"])
  vals = torch.zeros_like(S.vals, dtype=torch.float64)
  mask = S.vals != 0
  check(int(mask.sum()) == S.nnz, "the urand graph stores a zero")
  vals[mask] = torch.from_numpy(urand_weights(S.nnz)).to(device)
  Sw = sparse.SparseArray(S.cols, vals, S.shape, S.nnz)
  del vals, mask
  dist_w = per_round(f"dijkstra weighted (0, 1], {k} sources, urand 2^22",
                     lambda: C.dijkstra(Sw, indices=list(CSG_SOURCES)),
                     lambda: CG.stats["rounds"])
  del Sw
  n_comp, labels = per_round(
      "connected_components (weak), urand 2^22",
      lambda: C.connected_components(S, directed=True, connection="weak"),
      lambda: CG.stats["rounds"])
  probes = [np.random.default_rng(28 + i).standard_normal(S.shape[0])
            for i in range(LAP_PROBES)]
  with Timer() as t_lap:
    L, d = C.laplacian(S, normed=True, return_diag=True)
    Lv = [sparse.spmv(L, torch.from_numpy(v).to(device)).cpu().numpy()
          for v in probes]
  del L
  want_u = oracle_result(oracles["unweighted"])
  want_w = oracle_result(oracles["weighted"])
  check(np.array_equal(dist, want_u), "unweighted dijkstra disagrees")
  finite = np.isfinite(want_w)
  err_w = float(np.abs(dist_w[finite] - want_w[finite]).max()
                / want_w[finite].max())
  check(np.array_equal(np.isfinite(dist_w), finite) and err_w <= 1e-12,
        f"weighted dijkstra disagrees ({err_w:.3g})")
  want_nc, want_labels, want_d, want_Lv = oracle_result(oracles["structure"])
  same = n_comp == want_nc and same_partition(labels, want_labels, n_comp)
  err_d = float(np.abs(d - want_d).max())
  err_L = max(float(np.abs(a - b).max() / np.abs(b).max())
              for a, b in zip(Lv, want_Lv))
  print(f"  held to scipy.sparse.csgraph on the host: unweighted distances "
        f"equal (max {np.nanmax(np.where(np.isfinite(dist), dist, np.nan)):.0f}"
        f" hops), weighted max rel err {err_w:.3g} (1e-12: the same path "
        f"sums), {n_comp} weak components ({want_nc}), the normed Laplacian's "
        f"diagonal max err {err_d:.3g} and L v max rel err {err_L:.3g} (1e-12)"
        f" over {LAP_PROBES} probes; laplacian and its products "
        f"{t_lap.elapsed:.2f} s")
  check(same and err_d <= 1e-12 and err_L <= 1e-12,
        "the components or the Laplacian disagree")
  G = cut_grid_graph(CUT_SIDE)
  Gs = sparse.from_scipy(G)
  nc, lab = per_round(f"connected_components of the {CUT_SIDE}^2 grid cut "
                      "in two", lambda: C.connected_components(
                          Gs, directed=False), lambda: CG.stats["rounds"])
  import scipy.sparse.csgraph as cs
  want_nc, want_lab = cs.connected_components(G, directed=False)
  check(nc == want_nc == 2 and same_partition(lab, want_lab, 2),
        "the cut grid's components disagree")
  Gf = fw_graph()
  with Timer() as t_fw:
    D = C.floyd_warshall(sparse.from_scipy(Gf))
  rows = np.random.default_rng(29).choice(FW_N, FW_SAMPLES, replace=False)
  want = cs.dijkstra(Gf, indices=rows)
  reach = np.isfinite(want)
  err_fw = float(np.abs(D[rows][reach] - want[reach]).max()
                 / want[reach].max())
  print(f"  floyd_warshall at n = {FW_N} ({Gf.nnz} edges): {t_fw.elapsed:.2f}"
        f" s, {t_fw.elapsed / FW_N * 1e3:.4f} ms a pivot (host clock); "
        f"{FW_SAMPLES} rows vs scipy's dijkstra max rel err {err_fw:.3g} "
        f"(1e-12)")
  check(np.array_equal(np.isfinite(D[rows]), reach) and err_fw <= 1e-12,
        "floyd_warshall disagrees with dijkstra")


def same_partition(a, b, count: int) -> bool:
  """Whether two labelings of the vertices, ``count`` classes each, put
  the same vertices together."""
  pairs = a.astype(np.int64) * (int(b.max()) + 1) + b
  return len(np.unique(pairs)) == count


def phase_autodiff_csgraph(device, card: str, S, want, k1_ms: float,
                           oracles: dict) -> dict:
  """Phase 22: sp.compile through K1 and K3b, the derivatives at config
  3's shape, through SpMV and SpMM, sp.minimize, convnet's training with
  remat, and sp.sparse.csgraph at full width, held to the scipy oracles
  of :func:`submit_phase22_oracles` (worker futures).  Returns the counted
  launches of K1 and K3b."""
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  t0 = time.perf_counter()
  ORACLE_WAIT[0] = 0.0

  def since(what: str) -> None:
    print(f"  [{time.perf_counter() - t0:.2f} s into phase 22: {what}]")

  with concurrent.futures.ThreadPoolExecutor(max_workers=6) as pool:
    counted, pending = compile_items(device, card, k1_ms, pool)
    counted["csr"] = compiled_pagerank(S, want)
    since("the compiled calls")
    X_host, y_host, labels, _ = config3_data()
    gradient_items(device, X_host, y_host)
    counted["csr"] += sparse_gradient_items(device, S)
    gc.collect()
    torch.cuda.empty_cache()
    since("the gradients")
    minimize_item(device, X_host, labels, oracles["bfgs"])
    del X_host, y_host, labels
    convnet_items(device, card)
    gc.collect()
    torch.cuda.empty_cache()
    since("minimize and convnet")
    hold_compiled(pending)
  csgraph_items(device, S, oracles)
  print(f"  phase 22 peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; "
        f"{time.perf_counter() - t0:.2f} s, {ORACLE_WAIT[0]:.2f} s of it waiting "
        "for the oracle processes")
  return counted


# -- phase 23: sp.optimize and sp.integrate ------------------------------------

FIT_M = 1 << 20  # the reference test's decay model over 2^20 samples
FIT_TRUE, FIT_NOISE, FIT_SEED = (2.5, 1.3, 0.4), 1e-3, 31
FIT_BOX = ([0.0, 0.0, 0.0], [5.0, 1.25, 1.0])  # p1 <= 1.25 binds (~1.3)
FIT_TOL = 1e-7  # on each parameter, against scipy's tight least_squares
ROSEN_N, ROSEN_BOX = 64, (-2.0, 0.8)
# the reference's BFGS (jax.scipy.optimize's) from zeros on the 64-parameter
# Rosenbrock function, run on the CPU (tests/test_torch_optimize.py): its
# line search fails after 95 iterations (status 3) far from the minimum,
# where scipy's BFGS converges; the port takes the same steps (f within
# 1e-9 relative on the CPU)
REF_BFGS = (95, 3, 55.7329477816631)
ROOT_N = 256
DE_DIM, DE_SEED = 8, 23
ODE_N = 1 << 16  # the heat equation's method-of-lines unknowns
ODE_MODE = ODE_N // 3  # the sine mode y0 is, of the discrete Laplacian
ODE_DECAY = 15.0  # lambda_k T: about 1000 accepted RK45 steps at rtol 1e-12
ODE_RTOL = {"RK45": 1e-12, "RK23": 1e-6}
ODE_ATOL = 1e-20
ODE_POINTS = 5  # t_eval
ODE_SHORT = 250  # the steps of the cut run the loop's timing differences
ODE_PROFILED = (60, 30)  # and of the two runs it profiles
QUAD_N = (1 << 24) + 1
CUBIC_ROOT = 2.0945514815423265  # x^3 - 2x - 5
DOTTIE = 0.7390851332151607  # cos x = x


def fit_data():
  """The reference test's ``p0 exp(-p1 t) + p2`` with noise, at FIT_M."""
  rng = np.random.default_rng(FIT_SEED)
  t = np.linspace(0.0, 3.0, FIT_M)
  y = (FIT_TRUE[0] * np.exp(-FIT_TRUE[1] * t) + FIT_TRUE[2]
       + FIT_NOISE * rng.standard_normal(FIT_M))
  return t, y


def fit_oracles():
  """scipy's least_squares at tolerances of 1e-14 with the exact
  Jacobian: 'lm' unbounded and 'trf' in FIT_BOX."""
  import scipy.optimize as so
  t, y = fit_data()

  def res(p):
    return p[0] * np.exp(-p[1] * t) + p[2] - y

  def jac(p):
    e = np.exp(-p[1] * t)
    return np.stack([e, -p[0] * t * e, np.ones_like(t)], axis=1)

  tight = {"xtol": 1e-14, "ftol": 1e-14, "gtol": 1e-14}
  lm = so.least_squares(res, np.ones(3), jac=jac, method="lm", **tight)
  trf = so.least_squares(res, np.ones(3), jac=jac, method="trf",
                         bounds=FIT_BOX, **tight)
  return lm.x, trf.x


def rosen_oracles():
  """scipy's BFGS and L-BFGS-B (in ROSEN_BOX) on the ROSEN_N-parameter
  Rosenbrock function from zeros, with its exact gradient."""
  import scipy.optimize as so
  x0 = np.zeros(ROSEN_N)
  bfgs = so.minimize(so.rosen, x0, jac=so.rosen_der, method="BFGS",
                     options={"gtol": 1e-10, "maxiter": 100_000})
  box = so.minimize(so.rosen, x0, jac=so.rosen_der, method="L-BFGS-B",
                    bounds=[ROSEN_BOX] * ROSEN_N,
                    options={"ftol": 1e-15, "gtol": 1e-12,
                             "maxiter": 100_000})
  return bfgs.x, box.x, float(box.fun)


def quad_samples() -> np.ndarray:
  """QUAD_N samples of exp(x) sin(7x) on [0, 1]."""
  x = np.linspace(0.0, 1.0, QUAD_N)
  return np.exp(x) * np.sin(7.0 * x)


def quad_oracles():
  """NumPy's and scipy's rules on the samples, with their absolute sum."""
  import scipy.integrate as si
  y = quad_samples()
  dx = 1.0 / (QUAD_N - 1)
  return {"trapezoid": float(np.trapezoid(y, dx=dx)),
          "simpson": float(si.simpson(y, dx=dx)),
          "romb": float(si.romb(y, dx=dx)),
          "cumulative_trapezoid": si.cumulative_trapezoid(y, dx=dx),
          "cumulative_simpson": si.cumulative_simpson(y, dx=dx),
          "abs": float(np.abs(y).sum() * dx)}


def submit_phase23_oracles(procs) -> dict:
  """Phase 23's host oracles, submitted to the worker processes before the
  build (seconds of scipy and NumPy each)."""
  return {"fit": procs.submit(fit_oracles),
          "rosen": procs.submit(rosen_oracles),
          "quad": procs.submit(quad_oracles)}


def _turns():
  return sp.optimize.counts["turns"]


def timed_loop(label, card: str, run, full: int, short: int, prof):
  """Host and device ms a turn of the loop ``run(limit)`` (``limit`` caps
  its turns: ``max_nfev``, ``max_steps``).  Host: the synced walls of a
  run of ``full`` and one of ``short`` turns, differenced (which takes out
  the lowering, the entry and the final evaluations) over the difference
  of their turns.  Device: the kernels of runs of ``prof[0]`` and
  ``prof[1]`` turns under torch.profiler, differenced the same way (a
  profile of a thousand turns takes the profiler minutes to fold), with
  the three kernels that take most of it (each the smaller of two
  profiles).  Returns the full run's result."""
  walls, turns, devs, dturns, names = [], [], [], [], []
  for limit in (full, short):
    torch.cuda.synchronize()
    before = _turns()
    with Timer() as t_wall:
      out = run(limit)
      torch.cuda.synchronize()
    turns.append(_turns() - before)
    walls.append(t_wall.elapsed * 1e3)
    if limit == full:
      result = out
  for limit in prof:
    # the smaller of two profiles: a run's set-up (the lowering, its
    # shape inference) is a few kernels whose time varies
    best = None
    for _ in range(2):
      before = _turns()
      by_name, dev_ms, _wall = device_share(lambda: run(limit))
      if best is None or best[1] is None or (dev_ms is not None
                                             and dev_ms < best[1]):
        best = (by_name, dev_ms, _turns() - before)
    names.append(best[0])
    devs.append(best[1])
    dturns.append(best[2])
  host = (walls[0] - walls[1]) / (turns[0] - turns[1])
  k = dturns[0] - dturns[1]
  dev = ("not measured" if None in devs else
         f"{(devs[0] - devs[1]) / k:.4f} ms")
  print(f"  {label}: {turns[0]} and {turns[1]} turns in {walls[0]:.1f} and "
        f"{walls[1]:.1f} ms: host {host:.4f} ms a turn, device {dev} a turn "
        f"(profiles of {dturns[0]} and {dturns[1]} turns) ({card})")
  if None not in devs:
    top = sorted(((names[0].get(key, 0.0) - names[1].get(key, 0.0)) / k, key)
                 for key in names[0])[-3:]
    print("    most of a turn's device time: " + "; ".join(
        f"{key[:60]} {ms:.4f} ms" for ms, key in reversed(top)))
  return result


def _on_card(seen: set, what: str, device) -> None:
  check(seen == {device.type}, f"{what}'s function saw tensors on {seen}")


def fit_items(device, card: str, oracle) -> None:
  """curve_fit and least_squares ('lm', then 'trf' in FIT_BOX) over FIT_M
  samples on the card, each parameter within FIT_TOL of scipy's."""
  O = sp.optimize
  t_host, y_host = fit_data()
  t = torch.as_tensor(t_host, device=device)
  y = torch.as_tensor(y_host, device=device)
  seen = set()

  def model(x, a, b, c):
    seen.add(x.device.type)
    return a * torch.exp(-b * x) + c

  def resid(p):
    seen.add(p.device.type)
    return p[0] * torch.exp(-p[1] * t) + p[2] - y

  before = dict(O.counts)
  popt, pcov = O.curve_fit(model, t, y, p0=np.ones(3))
  cols = O.counts["jacobian_columns"] - before["jacobian_columns"]
  check(O.counts["jacobian_rows"] == before["jacobian_rows"] and cols > 0,
        "the fit's Jacobian was not built by columns")
  lm = timed_loop(f"least_squares 'lm' over {FIT_M} samples", card,
                  lambda limit: O.least_squares(resid, np.ones(3),
                                                method="lm",
                                                max_nfev=limit),
                  full=200, short=4, prof=(200, 1))
  trf = O.least_squares(resid, np.ones(3), method="trf", bounds=FIT_BOX)
  _on_card(seen, "the fit", device)
  want_lm, want_trf = oracle_result(oracle)
  for label, got, want in (("curve_fit", popt, want_lm),
                           ("least_squares lm", lm.x, want_lm),
                           ("least_squares trf", trf.x, want_trf)):
    err = float(np.abs(np.asarray(got) - want).max())
    print(f"  {label}: {np.array2string(np.asarray(got), precision=9)}, "
          f"{err:.3e} from scipy's (bound {FIT_TOL})")
    check(err <= FIT_TOL, f"{label} is {err:.3e} from scipy's optimum")
  check(lm.success and trf.success, "a fit did not report success")
  check(abs(trf.x[1] - FIT_BOX[1][1]) <= 1e-12,
        f"the bound p1 <= {FIT_BOX[1][1]} does not bind ({trf.x[1]})")
  check(np.all(np.isfinite(pcov)) and pcov.shape == (3, 3),
        "curve_fit's covariance")


def _rosen_torch(p):
  return torch.sum(100.0 * (p[1:] - p[:-1] ** 2) ** 2 + (1.0 - p[:-1]) ** 2)


def minimize_items(device, oracle) -> None:
  """BFGS on the 64-parameter Rosenbrock function to the reference's
  outcome (REF_BFGS: its iterations and status, f at 1e-6 relative); the
  box solver there against scipy's L-BFGS-B (x at 1e-4 and f at 1e-6
  relative, the reference test's); root of a 256-unknown cubic system to
  its known root (1e-9: |F| <= 1e-10 and ||J^-1|| <= 1/2); the scalar
  solvers on 0-d tensors of the card to their closed forms."""
  O = sp.optimize
  want_bfgs, want_box, want_fun = oracle_result(oracle)
  with Timer() as t_b:
    m = O.minimize(_rosen_torch, np.zeros(ROSEN_N))
  err = float(np.abs(m.x - want_bfgs).max())
  print(f"  minimize BFGS, {ROSEN_N} parameters: {m.nit} iterations in "
        f"{t_b.elapsed:.2f} s, status {m.status}, f {m.fun!r} ({err:.3e} "
        f"from scipy's BFGS, which converges; the reference stops at "
        f"status {REF_BFGS[1]}, f {REF_BFGS[2]!r} after {REF_BFGS[0]})")
  check((m.nit, m.status) == REF_BFGS[:2]
        and abs(m.fun - REF_BFGS[2]) <= 1e-6 * REF_BFGS[2],
        "BFGS on Rosenbrock left the reference's path")
  with Timer() as t_b:
    b = O.minimize(_rosen_torch, np.zeros(ROSEN_N),
                   bounds=[ROSEN_BOX] * ROSEN_N)
  err = float(np.abs(b.x - want_box).max())
  print(f"  minimize in [{ROSEN_BOX[0]}, {ROSEN_BOX[1]}]^{ROSEN_N}: "
        f"{b.nit} projected Newton steps in {t_b.elapsed:.2f} s, {err:.3e} "
        f"from L-BFGS-B's x, f {b.fun:.12g} against {want_fun:.12g}")
  check(b.success and err <= 1e-4
        and abs(b.fun - want_fun) <= 1e-6 * abs(want_fun),
        "the box solver against L-BFGS-B")
  # root: T x + x^3 / 10 = b, T = tridiag(-1, 4, -1), at a known x*
  xs = np.cos(np.linspace(0.0, np.pi, ROOT_N))
  Tx = 4.0 * xs
  Tx[1:] -= xs[:-1]
  Tx[:-1] -= xs[1:]
  bvec = torch.as_tensor(Tx + 0.1 * xs ** 3, device=device)
  pad = torch.nn.functional.pad

  def system(p):
    return (4.0 * p - pad(p[:-1], (1, 0)) - pad(p[1:], (0, 1))
            + 0.1 * p ** 3 - bvec)

  with Timer() as t_r:
    r = O.root(system, np.zeros(ROOT_N))
  err = float(np.abs(r.x - xs).max())
  print(f"  root, {ROOT_N} unknowns: {r.nit} Newton steps in "
        f"{t_r.elapsed:.2f} s, {err:.3e} from the known root")
  check(r.success and err <= 1e-9, f"root is {err:.3e} from x*")
  seen = set()

  def scalar(f):
    def g(x):
      seen.add(x.device.type)
      return f(x)
    return g

  got = {"brentq": O.brentq(scalar(lambda x: torch.exp(x) - 10.0), 0.0, 5.0),
         "ridder": O.ridder(scalar(lambda x: x ** 3 - 2 * x - 5), 2.0, 3.0),
         "bisect": O.bisect(scalar(lambda x: x ** 3 - 2.0), 0.0, 2.0),
         "newton": O.newton(scalar(lambda x: torch.cos(x) - x), 0.5)}
  want = {"brentq": np.log(10.0), "ridder": CUBIC_ROOT,
          "bisect": 2.0 ** (1.0 / 3.0), "newton": DOTTIE}
  for name, v in got.items():
    tol = 1e-8 if name == "newton" else 1e-10
    print(f"  {name}: {v!r}, {abs(v - want[name]):.3e} from the root")
    check(abs(v - want[name]) <= tol, f"{name} missed its root")
  _on_card(seen, "the scalar solvers", device)


def _rastrigin(p):
  return 10.0 * p.shape[-1] + torch.sum(p * p - 10.0 * torch.cos(
      2.0 * np.pi * p))


def population_items(card: str) -> None:
  """differential_evolution on the 8-D Rastrigin function to its global
  minimum 0 at 0 (f below 1e-8, x within 1e-5); Nelder-Mead (fmin) of the
  4-D Rosenbrock function to its minimum at ones (1e-3, the reference
  test's)."""
  O = sp.optimize
  with Timer() as t_de:
    de = O.differential_evolution(_rastrigin, [(-5.12, 5.12)] * DE_DIM,
                                  seed=DE_SEED, tol=1e-8, popsize=20,
                                  recombination=0.2)
  print(f"  differential_evolution, {DE_DIM}-D Rastrigin: {de.nit} "
        f"generations of {20 * DE_DIM} in {t_de.elapsed:.2f} s, f "
        f"{de.fun:.3e}, max|x| {np.abs(de.x).max():.3e}")
  check(de.fun <= 1e-8 and np.abs(de.x).max() <= 1e-5,
        "differential_evolution missed Rastrigin's global minimum")
  with Timer() as t_nm:
    x, fx, it, _, flag = O.fmin(O.rosen, np.array([1.3, 0.7, 0.8, 1.9]),
                                xtol=1e-8, ftol=1e-12, maxiter=4000,
                                full_output=True)
  print(f"  fmin (Nelder-Mead), 4-D Rosenbrock: {it} iterations in "
        f"{t_nm.elapsed:.2f} s, {np.abs(x - 1.0).max():.3e} from ones")
  check(flag == 0 and np.abs(x - 1.0).max() <= 1e-3, "fmin missed ones")


def heat_ode(device):
  """The method-of-lines heat equation y' = L y (Dirichlet, h = 1 /
  (ODE_N + 1)), y0 the ODE_MODE-th sine mode of L, its eigenvalue."""
  h = 1.0 / (ODE_N + 1)
  x = torch.arange(1, ODE_N + 1, dtype=torch.float64, device=device) * h
  lam = 4.0 / h ** 2 * np.sin(ODE_MODE * np.pi * h / 2.0) ** 2
  y0 = torch.sin(ODE_MODE * np.pi * x)
  seen = set()

  def fun(t, y):
    seen.add(y.device.type)
    out = -2.0 * y
    out[1:] += y[:-1]
    out[:-1] += y[1:]
    return out / h ** 2

  return fun, y0, lam, seen


def ode_items(device, card: str) -> None:
  """solve_ivp RK45 and RK23 of the heat equation from one sine mode,
  whose semi-discrete solution is exp(-lambda t) y0: at each t_eval point
  the RMS error is held to the steps taken times (atol + rtol max|y0|),
  the bound the local error control gives a decaying linear system."""
  fun, y0, lam, seen = heat_ode(device)
  T = ODE_DECAY / lam
  te = np.linspace(0.0, T, ODE_POINTS)
  want = np.exp(-lam * te)[None, :] * y0.cpu().numpy()[:, None]
  for method in ("RK45", "RK23"):
    rtol = ODE_RTOL[method]

    def run(limit=100_000):
      return sp.integrate.solve_ivp(fun, (0.0, T), y0, method=method,
                                    t_eval=te, rtol=rtol, atol=ODE_ATOL,
                                    max_steps=limit)

    res = (timed_loop(f"solve_ivp {method}, {ODE_N} unknowns", card, run,
                      full=100_000, short=ODE_SHORT, prof=ODE_PROFILED)
           if method == "RK45" else run())
    steps = res.nfev // (7 if method == "RK45" else 4)
    rms = np.sqrt(np.mean((res.y - want) ** 2, axis=0))
    limit = steps * (ODE_ATOL + rtol * 1.0)
    print(f"  {method}: {steps} steps (accepted and rejected) to "
          f"lambda T = {ODE_DECAY}, RMS error {rms.max():.3e} (bound "
          f"{limit:.3e}), y(T) / y0 = {np.exp(-lam * T):.3e}")
    check(res.success and res.y.shape == (ODE_N, ODE_POINTS)
          and rms.max() <= limit, f"{method} on the heat equation")
  _on_card(seen, "solve_ivp", device)


def quad_items(device, oracle) -> None:
  """trapezoid, simpson, romb and the cumulative rules over QUAD_N float64
  samples on the card against NumPy's and scipy's, each held to the
  worst-case rounding of both sums, 4 n eps sum|y| dx; fixed_quad,
  tanhsinh and qmc_quad against their closed forms."""
  import math
  I = sp.integrate
  host = quad_samples()
  dx = 1.0 / (QUAD_N - 1)
  yd = torch.as_tensor(host, device=device)
  want = oracle_result(oracle)
  limit = 4.0 * QUAD_N * np.finfo(np.float64).eps * want["abs"]
  with Timer() as t_q:
    got = {"trapezoid": I.trapezoid(yd, dx=dx),
           "simpson": I.simpson(yd, dx=dx),
           "romb": I.romb(yd, dx=dx),
           "cumulative_trapezoid": I.cumulative_trapezoid(yd, dx=dx),
           "cumulative_simpson": I.cumulative_simpson(yd, dx=dx)}
    got = {k: v.evaluate().data for k, v in got.items()}
    torch.cuda.synchronize()
  for name, v in got.items():
    check(v.device == device, f"{name} left the card")
    v = v.cpu().numpy()
    err = float(np.abs(v - want[name]).max())
    print(f"  {name} of {QUAD_N} samples: {err:.3e} from the host's "
          f"(bound {limit:.3e})")
    check(v.shape == np.shape(want[name]) and err <= limit, name)
  print(f"  the five rules in {t_q.elapsed:.3f} s")
  fq, _ = I.fixed_quad(lambda x: torch.exp(-x) * torch.sin(3.0 * x), 0.0,
                       2.0, n=12)
  fq_want = (3.0 - np.exp(-2.0) * (np.sin(6.0) + 3.0 * np.cos(6.0))) / 10.0
  ts = I.tanhsinh(lambda x: torch.exp(-x * x), -3.0, 3.0)
  ts_want = math.sqrt(math.pi) * math.erf(3.0)
  qm = I.qmc_quad(lambda x: torch.sum(x ** 2), np.zeros(4), np.ones(4),
                  n_points=4096)
  for label, v, w, tol in (("fixed_quad", fq, fq_want, 1e-12),
                           ("tanhsinh", ts.integral, ts_want, 1e-11),
                           ("qmc_quad", qm.integral, 4.0 / 3.0, 5e-3)):
    print(f"  {label}: {v!r}, {abs(v - w):.3e} from the closed form "
          f"(bound {tol})")
    check(abs(v - w) <= tol, f"{label} against its closed form")


def phase_optimize_integrate(device, card: str, oracles: dict) -> None:
  """Phase 23: sp.optimize and sp.integrate on the card in float64."""
  from spartan_tpu_torch.expr import fio
  t0 = time.perf_counter()
  runs = fio.counts["host_runs"]
  ORACLE_WAIT[0] = 0.0

  def since(what: str) -> None:
    print(f"  [{time.perf_counter() - t0:.2f} s into phase 23: {what}]")

  fit_items(device, card, oracles["fit"])
  since("the fits")
  minimize_items(device, oracles["rosen"])
  since("the minimizers and root finders")
  population_items(card)
  since("the population methods")
  ode_items(device, card)
  since("the ODEs")
  quad_items(device, oracles["quad"])
  # one host boundary of each namespace, counted
  v, _ = sp.integrate.quad(lambda x: np.exp(-x), 0.0, np.inf)
  x, _ = sp.optimize.nnls(np.eye(3), np.array([1.0, -1.0, 2.0]))
  check(abs(v - 1.0) <= 1e-10 and np.allclose(x, [1.0, 0.0, 2.0]),
        "the host boundaries")
  host_runs = fio.counts["host_runs"] - runs
  print(f"  phase 23 host_runs {host_runs}; "
        f"{time.perf_counter() - t0:.2f} s, {ORACLE_WAIT[0]:.2f} s of it "
        "waiting for the oracle processes")
  check(host_runs == 2, f"phase 23 counted {host_runs} host runs, not 2")


# phase 24: the remaining examples through learn's estimators at full
# width, sp.special at 2^24 points, and the examples' CLI runner
P24_SEED = 24
REG_N, REG_D, REG_ITERS = 1 << 20, 64, 20      # config 3's shape
LASSO_REG, LASSO_ITERS = 0.05, 30
PCA_K, PCA_DECAY = 4, 0.8  # PCA's axes scaled by 0.8^i: a 0.64 eigen-ratio
CL_N, CL_D, CL_K, CL_ITERS = 1 << 19, 64, 64, 5  # config 4's shape
RINGS_N = 4096
KNN_TRAIN, KNN_QUERIES, KNN_D, KNN_K, KNN_CLASSES = 1 << 16, 1 << 12, 64, 5, 16
NB_DOCS, NB_WORDS, NB_CLASSES, NB_LEN = 1 << 20, 256, 20, 50
NF_K, NF_BATCH, NF_RATINGS = 64, 4096, 1 << 18  # 64 steps at ML-20M's shape
ALS24_ITERS = 2
BS_N, BS_SAMPLE = 1 << 26, 1 << 20
SPECIAL_N, SPECIAL_SAMPLE = 1 << 24, 1 << 16
# the inverses whose bisection calls betainc's continued fraction (or
# kolmogorov's 100 terms) at each of 2 x 90 halvings: about 10^5 launches
# each, 1.9-6.5 s at 2^20 points on an H100 80GB HBM3 at 700 W, so they
# run at 2^18
SPECIAL_SLOW = ("betaincinv", "betainccinv", "stdtrit", "fdtri", "bdtri",
                "nbdtri", "kolmogi")
SPECIAL_SLOW_N = 1 << 18
# trimmed for the script's time (it ran 1016.58 s after phase 0 with them
# on an H100 80GB HBM3 at 700 W): the four that bisect through betainc's
# continued fraction by ``special._betaincinv_kern`` run in phase 25
# instead, as t/f/beta's ppf and isf at 2^16 points against scipy (the
# CPU test holds each name)
SPECIAL_IN_PHASE25 = ("betaincinv", "betainccinv", "stdtrit", "fdtri")
# trimmed for phase 26's time: the other three launch-bound inverses
# (bdtri and nbdtri bisect through betainc's continued fraction as the four
# above do, kolmogi through kolmogorov's 100 terms, which this phase runs
# forward at 2^24); tests/test_torch_special.py holds each against scipy
# and the reference on the CPU
SPECIAL_OFF_CARD = ("bdtri", "nbdtri", "kolmogi")
SPECIAL_TIMED = ("betainc", "gammaincinv", "hyp1f1", "ellipk")


def regression_data():
  """Config 3's X (2^20 x 64 float64), a linear target with noise, and its
  sign (the classifiers' labels)."""
  rng = np.random.default_rng(P24_SEED)
  X = rng.standard_normal((REG_N, REG_D))
  w = rng.standard_normal(REG_D)
  w[REG_D // 2:] = 0.0  # a sparse truth for Lasso
  y = X @ w + 0.1 * rng.standard_normal(REG_N)
  return X, y


def lasso_oracle():
  """lasso.fit_numpy on regression_data (a worker process)."""
  from spartan_tpu_torch.examples import lasso
  X, y = regression_data()
  return lasso.fit_numpy(X, y, LASSO_REG, LASSO_ITERS)


def cluster_data():
  """Config 4's shape: CL_K blobs at 6 sigma in CL_D dimensions, float64
  (examples/kmeans.make_data's draw)."""
  rng = np.random.default_rng(P24_SEED + 1)
  true_centers = rng.standard_normal((CL_K, CL_D)) * 6.0
  labels = rng.integers(0, CL_K, CL_N)
  return true_centers[labels] + rng.standard_normal((CL_N, CL_D))


def gmm_oracle(mu0, var0, pi0):
  """gmm.em_numpy from the card's start (a worker process)."""
  from spartan_tpu_torch.examples import gmm
  return gmm.em_numpy(cluster_data(), mu0, var0, pi0, CL_ITERS)


def knn_data():
  """knn.make_blobs at KNN_CLASSES classes: the train set and the
  queries."""
  from spartan_tpu_torch.examples import knn
  X, y = knn.make_blobs(KNN_TRAIN + KNN_QUERIES, KNN_D,
                        n_classes=KNN_CLASSES, seed=P24_SEED + 2)
  return X[:KNN_TRAIN], y[:KNN_TRAIN], X[KNN_TRAIN:]


def knn_oracle():
  """NumPy's k nearest by argpartition of the Gram-term distances, their
  majority labels, and each query's gap between its k-th and (k+1)-th
  distance (a worker process)."""
  Xt, yt, Q = knn_data()
  d2 = ((Q * Q).sum(1)[:, None] + (Xt * Xt).sum(1)[None, :]
        - 2.0 * Q @ Xt.T)
  part = np.partition(d2, KNN_K, axis=1)
  gap = part[:, KNN_K] - part[:, KNN_K - 1]
  idx = np.argpartition(d2, KNN_K, axis=1)[:, :KNN_K]
  labels = np.array([np.bincount(yt[r], minlength=KNN_CLASSES).argmax()
                     for r in idx])
  return labels, gap, float(np.abs(d2).max())


def submit_phase24_oracles(procs) -> dict:
  """Phase 24's host oracles, submitted to the worker processes before the
  build (the lasso loop and the k-NN distances, seconds each); GMM's
  follows once the card has its start."""
  return {"lasso": procs.submit(lasso_oracle),
          "knn": procs.submit(knn_oracle)}


def _rel(a, b) -> float:
  a = torch.as_tensor(np.asarray(a) if not isinstance(a, torch.Tensor)
                      else a).double()
  b = torch.as_tensor(np.asarray(b) if not isinstance(b, torch.Tensor)
                      else b).double().to(a.device)
  return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))


def _held24(label: str, err: float, tol: float, why: str) -> None:
  print(f"  {label}: {err:.3g} (bound {tol:.3g}: {why})")
  check(err <= tol, f"phase 24: {label} {err:.3g} > {tol:.3g}")


def step_ms(run, many: int, few: int):
  """(host ms, device ms) a turn of ``run(turns)``: the synced walls of
  ``many`` and ``few`` turns differenced, and the device-busy ms of both
  under torch.profiler differenced (None when the profiler saw no device
  event)."""
  walls, devs = [], []
  for turns in (many, few):
    run(turns)  # warm: the step's first call pays its set-up
    torch.cuda.synchronize()
    with Timer() as t:
      run(turns)
      torch.cuda.synchronize()
    walls.append(t.elapsed * 1e3)
    devs.append(device_share(lambda: run(turns))[1])
  host = (walls[0] - walls[1]) / (many - few)
  dev = None if None in devs else (devs[0] - devs[1]) / (many - few)
  return host, dev


def regression_items(device, card: str, oracles) -> None:
  """LinearRegression, LogisticRegression, SVC, Ridge and Lasso at config
  3's shape, each held to its example's stepwise fit on the card (Ridge to
  a float64 solve on the card, Lasso to lasso.fit_numpy in a worker), PCA
  to eigvalsh of the covariance, and one FISTA step's host and device
  ms."""
  from spartan_tpu_torch import learn
  from spartan_tpu_torch.examples import lasso, svm
  X, y = regression_data()
  yb = (y > 0).astype(np.float64)
  ys = np.where(y > 0, 1.0, -1.0)
  Xa = sp.from_numpy(X).value  # one upload, shared by the estimators
  Xd = sp.lazify(Xa)
  # same float64 operations as the stepwise loop in another grouping:
  # a few ulps a step of the weights' size
  fused = 1e-11
  m = learn.LinearRegression(iterations=REG_ITERS, alpha=0.05).fit(Xa, y)
  w = np.asarray(linear_reg.fit(Xd, sp.from_numpy(y), REG_ITERS,
                                0.05).glom())
  _held24("LinearRegression against linear_reg.fit", _rel(m.coef_, w),
          fused, "fused and stepwise float64")
  m = learn.LogisticRegression(iterations=REG_ITERS, alpha=1.0).fit(Xa, yb)
  w = np.asarray(logistic_reg.fit(Xd, sp.from_numpy(yb), REG_ITERS,
                                  1.0).glom())
  _held24("LogisticRegression against logistic_reg.fit", _rel(m.coef_, w),
          fused, "fused and stepwise float64")
  m = learn.SVC(iterations=REG_ITERS, alpha=0.1, C=10.0).fit(Xa, ys)
  w = np.asarray(svm.fit(Xd, sp.from_numpy(ys), REG_ITERS, 0.1,
                         10.0).glom())
  _held24("SVC against svm.fit", _rel(m.coef_, w), fused,
          "fused and stepwise float64")
  m = learn.Ridge(alpha=1.0).fit(Xa, y)
  Xt = Xa.data
  yt = torch.as_tensor(y, device=device)
  want = torch.linalg.solve(Xt.T @ Xt + torch.eye(REG_D, device=device,
                                                  dtype=torch.float64),
                            Xt.T @ yt)
  _held24("Ridge against a float64 solve on the card", _rel(m.coef_, want),
          1e-12, "Gram condition ~1.1: the same float64 solve")
  m = learn.Lasso(alpha=LASSO_REG, iterations=LASSO_ITERS).fit(Xa, y)
  w_np = oracle_result(oracles["lasso"])
  _held24("Lasso against lasso.fit_numpy (worker)", _rel(m.coef_, w_np),
          1e-9, "2^20-term float64 sums in another order through 30 "
          "FISTA steps")
  scale = PCA_DECAY ** np.arange(REG_D)
  p = learn.PCA(n_components=PCA_K, iterations=60).fit(
      Xd * sp.from_numpy(scale))
  Xs = Xt * torch.as_tensor(scale, device=device)
  Xc = Xs - Xs.mean(0)
  evals = torch.linalg.eigvalsh(Xc.T @ Xc / REG_N).flip(0)[:PCA_K]
  _held24("PCA's explained variance against eigvalsh", _rel(
      p.explained_variance_, evals), 1e-9, "60 subspace steps at an "
      "eigen-ratio near 0.64: 0.64^60 of the subspace, squared in the "
      "values")
  check(p.transform(Xd * sp.from_numpy(scale)).shape == (REG_N, PCA_K),
        "PCA.transform's shape")
  del Xt, Xs, Xc
  host, dev = step_ms(lambda n: lasso.fit_fused(Xd, sp.from_numpy(y),
                                                LASSO_REG, n).glom(), 40, 10)
  print(f"  one FISTA make_fori step at {REG_N} x {REG_D} float64: host "
        f"{host:.4f} ms, device "
        f"{'not measured' if dev is None else f'{dev:.4f} ms'} ({card})")


def gmm_start(procs):
  """Config 4's points on the card, GaussianMixture's start there (the
  farthest-point seeding, the pooled variance, equal weights), and
  gmm.em_numpy from it submitted to a worker: (X, its array, the
  pending oracle)."""
  X = cluster_data()
  Xa = sp.from_numpy(X).value
  Xd = sp.lazify(Xa)
  mu0 = kmeans.farthest_init(Xd, CL_K, P24_SEED)
  var0 = np.ones((CL_K, CL_D)) * float(
      np.asarray(sp.var(Xd, axis=0).glom()).mean())
  pi0 = np.full(CL_K, 1.0 / CL_K)
  return X, Xa, procs.submit(gmm_oracle, mu0, var0, pi0)


def clustering_items(device, card: str, start) -> None:
  """GaussianMixture (held to gmm.em_numpy from the same start in a
  worker, submitted by :func:`gmm_start`), FuzzyKMeans (to
  fuzzy_kmeans.fit on the card) and KMeans (to kmeans.fit_fused from the
  same centers) at config 4's shape; SpectralClustering on two rings of
  RINGS_N points."""
  from spartan_tpu_torch import learn
  from spartan_tpu_torch.examples import fuzzy_kmeans
  X, Xa, pending = start
  Xd = sp.lazify(Xa)
  g = learn.GaussianMixture(CL_K, iterations=CL_ITERS, seed=P24_SEED).fit(Xa)
  fz = learn.FuzzyKMeans(CL_K, iterations=CL_ITERS, seed=P24_SEED).fit(Xa)
  c_step, u_step = fuzzy_kmeans.fit(Xd, CL_K, CL_ITERS, seed=P24_SEED)
  _held24("FuzzyKMeans against fuzzy_kmeans.fit", max(
      _rel(fz.cluster_centers_, np.asarray(c_step.glom())),
      _rel(fz.membership_, np.asarray(u_step.glom()))), 1e-9,
          "fused and stepwise float64 over 5 steps")
  km = learn.KMeans(CL_K, iterations=CL_ITERS, seed=P24_SEED).fit(Xa)
  c0 = X[np.random.default_rng(P24_SEED).choice(CL_N, CL_K, replace=False)]
  c_fused = kmeans.fit_fused(Xd, CL_K, CL_ITERS, centers=sp.from_numpy(c0))
  _held24("KMeans against kmeans.fit_fused", _rel(
      km.cluster_centers_, np.asarray(c_fused.glom())), 1e-12,
          "one-hot sums in float64 in another order; labels equal")
  rng = np.random.default_rng(P24_SEED)
  th = rng.uniform(0, 2 * np.pi, RINGS_N)
  r = np.concatenate([np.full(RINGS_N // 2, 1.0),
                      np.full(RINGS_N - RINGS_N // 2, 3.0)])
  r = r + 0.05 * rng.standard_normal(RINGS_N)
  rings = np.stack([r * np.cos(th), r * np.sin(th)], axis=1)
  truth = np.arange(RINGS_N) >= RINGS_N // 2
  labels = learn.SpectralClustering(2, gamma=4.0).fit_predict(rings)
  acc = max(float((labels == truth).mean()), float((labels != truth).mean()))
  print(f"  SpectralClustering of two rings of {RINGS_N} points: accuracy "
        f"{acc}")
  check(acc == 1.0, "SpectralClustering did not separate the rings")
  mo, vo, po = oracle_result(pending)
  _held24("GaussianMixture against gmm.em_numpy (worker)", max(
      _rel(g.means_, mo), _rel(g.variances_, vo), _rel(g.weights_, po)),
          1e-9, "float64 EM, 2^19-term sums in another order, 5 steps")


def knn_item(card: str, oracles) -> None:
  """KNeighborsClassifier on a train set of 2^16 x 64 and 2^12 queries
  (a 2 GB float64 distance matrix), its labels held to NumPy's
  argpartition in a worker wherever the k-th and (k+1)-th distances are
  apart by more than the distances' rounding."""
  from spartan_tpu_torch import learn
  Xt, yt, Q = knn_data()
  with Timer() as t:
    est = learn.KNeighborsClassifier(KNN_K).fit(Xt, yt)
    pred = est.predict(Q)
  want, gap, scale = oracle_result(oracles["knn"])
  # the Gram-term distances of the card and of NumPy round apart by a few
  # ulps of the largest term; a query whose k-th and (k+1)-th neighbours
  # are nearer than that may order them either way
  tied = gap <= 64 * EPS64 * scale
  wrong = int(((pred != want) & ~tied).sum())
  print(f"  KNeighborsClassifier k={KNN_K}: {KNN_QUERIES} queries against "
        f"{KNN_TRAIN} x {KNN_D} in {t.elapsed:.2f} s (fit and predict, "
        f"host clock); {int(tied.sum())} queries within rounding of a tie; "
        f"{wrong} labels differ from NumPy's elsewhere; agreement "
        f"{float((pred == want).mean())}")
  check(wrong == 0, "k-NN labels differ from NumPy's argpartition")


def naive_bayes_item(device, pool) -> None:
  """NaiveBayes on 2^20 documents of 256 word counts and 20 classes,
  drawn on the card in one vectorized call; the one-hot and the shuffle
  routes against each other and against NumPy's per-class sums."""
  from spartan_tpu_torch import learn
  from spartan_tpu_torch.examples import naive_bayes
  gen = torch.Generator(device=device).manual_seed(P24_SEED)
  rng = np.random.default_rng(P24_SEED)
  profiles = torch.as_tensor(rng.dirichlet(np.ones(NB_WORDS), NB_CLASSES),
                             device=device)
  labels = torch.randint(0, NB_CLASSES, (NB_DOCS,), device=device,
                         generator=gen)
  words = torch.multinomial(profiles[labels], NB_LEN, replacement=True,
                            generator=gen)
  counts = torch.zeros((NB_DOCS, NB_WORDS), dtype=torch.float64,
                       device=device)
  counts.scatter_add_(1, words, torch.ones_like(words, dtype=torch.float64))
  del words
  host_counts = counts.to(torch.uint8).cpu().numpy()
  host_labels = labels.cpu().numpy()

  def oracle():
    feat = np.stack([np.bincount(host_labels, weights=host_counts[:, j],
                                 minlength=NB_CLASSES)
                     for j in range(NB_WORDS)], axis=1) + 1.0
    cls = np.bincount(host_labels, minlength=NB_CLASSES)
    return (np.log(cls / NB_DOCS),
            np.log(feat) - np.log(feat.sum(1, keepdims=True)))
  pending = pool.submit(oracle)
  X = sp.SpartanArray(counts)
  with Timer() as t:
    est = learn.NaiveBayes().fit(X, host_labels)
    pred = est.predict(X)
  lp, ll = naive_bayes.fit(sp.lazify(X), sp.from_numpy(host_labels),
                           NB_CLASSES, use_matmul=False)
  lp, ll = np.asarray(lp.glom()), np.asarray(ll.glom())
  want_lp, want_ll = pending.result()
  # integer counts sum exactly in float64 on every route; the logs round
  err = max(_rel(est.log_prior_, lp), _rel(est.log_likelihood_, ll))
  _held24("NaiveBayes's one-hot route against its shuffle route", err,
          1e-14, "exact integer sums, a few roundings of the logs")
  err = max(_rel(est.log_prior_, want_lp), _rel(est.log_likelihood_,
                                                want_ll))
  _held24("NaiveBayes against NumPy's per-class sums", err, 1e-14,
          "exact integer sums, a few roundings of the logs")
  print(f"  NaiveBayes fit and predict of {NB_DOCS} x {NB_WORDS}: "
        f"{t.elapsed:.2f} s (host clock); training accuracy "
        f"{float((pred == host_labels).mean()):.4f}")


def netflix_items(device, card: str) -> None:
  """Netflix SGD at MovieLens 20M's shape (138,493 x 26,744, k = 64,
  batches of 4096 over 2^18 ratings: 64 steps): fit against
  fit_compiled, one step by the one-hot route against the scatter route,
  and one compiled step's host and device ms.  The one-hot of a batch's
  users is 4096 x 138,493 float64, 4.5 GB."""
  from spartan_tpu_torch.examples import netflix_sgd as nf
  rng = np.random.default_rng(P24_SEED)
  users = rng.integers(0, ML_USERS, NF_RATINGS)
  items = rng.integers(0, ML_MOVIES, NF_RATINGS)
  ratings = rng.uniform(0.5, 5.0, NF_RATINGS)
  with Timer() as t_fit:
    U1, V1 = nf.fit(users, items, ratings, ML_USERS, ML_MOVIES, NF_K,
                    epochs=1, batch=NF_BATCH)
    U1, V1 = U1.data, V1.data
    torch.cuda.synchronize()
  with Timer() as t_comp:
    U2, V2 = nf.fit_compiled(users, items, ratings, ML_USERS, ML_MOVIES,
                             NF_K, epochs=1, batch=NF_BATCH)
    U2, V2 = U2.data, V2.data
    torch.cuda.synchronize()
  print(f"  netflix_sgd.fit {t_fit.elapsed:.2f} s, fit_compiled "
        f"{t_comp.elapsed:.2f} s for {NF_RATINGS // NF_BATCH} steps (host "
        "clock, the first calls included)")
  # the same float64 operations in both: a few ulps a step, 64 steps
  _held24("netflix fit against fit_compiled", max(_rel(U1, U2),
                                                   _rel(V1, V2)),
          1e-12, "64 steps x 8 ulps")
  U0 = torch.randn((ML_USERS, NF_K), dtype=torch.float64, device=device,
                   generator=torch.Generator(device=device).manual_seed(1))
  V0 = U0[:ML_MOVIES].clone()
  sel = slice(0, NF_BATCH)
  args = (sp.Val(sp.SpartanArray(U0)), sp.Val(sp.SpartanArray(V0)),
          sp.from_numpy(users[sel]), sp.from_numpy(items[sel]),
          sp.from_numpy(ratings[sel]))
  a = sp.evaluate(sp.ListExpr(list(nf.sgd_step(*args, use_matmul=True))))
  b = sp.evaluate(sp.ListExpr(list(nf.sgd_step(*args, use_matmul=False))))
  # a row's sum of its updates in another order (atomics on the card):
  # within 16 ulps of the row's absolute sum (a row takes at most 15
  # updates a batch here)
  ub, ib, rb = (torch.as_tensor(v[sel], device=device)
                for v in (users, items, ratings))
  Uu, Vi = U0[ub], V0[ib]
  e = ((Uu * Vi).sum(1) - rb)[:, None]
  lr, reg = 0.05, 0.02  # sgd_step's defaults
  err = 0.0
  for got, want, base, idx, g in (
      (a[0].data, b[0].data, U0, ub, e * Vi + reg * Uu),
      (a[1].data, b[1].data, V0, ib, e * Uu + reg * Vi)):
    mass = base.abs().index_add(0, idx, (lr * g).abs())
    err = max(err, float(((got - want).abs() / mass.clamp_min(1e-300))
                         .max()) / EPS64)
    dup = int(torch.bincount(idx).max())
    check(dup <= 15, f"a row takes {dup} updates in the batch")
  _held24("netflix one-hot step against the scatter step (ulps of the "
          "row's absolute sum)", err, 16.0, "the same sums in another "
          "order")
  Ut = sp.from_numpy(np.zeros((ML_USERS, NF_K)))
  Vt = sp.from_numpy(np.zeros((ML_MOVIES, NF_K)))
  leaves = [Ut, Vt, sp.from_numpy(users[sel]), sp.from_numpy(items[sel]),
            sp.from_numpy(ratings[sel])]
  step = sp.compile(sp.ListExpr(list(nf.sgd_step(*leaves))), wrt=leaves)

  def run(turns):
    U, V = U0, V0
    for _ in range(turns):
      U, V = step(U, V, ub, ib, rb)
      U, V = U.data, V.data
  host, dev = step_ms(run, 8, 2)
  print(f"  one compiled netflix step (batch {NF_BATCH}, k {NF_K}, the "
        f"users' one-hot {NF_BATCH} x {ML_USERS} float64 = "
        f"{NF_BATCH * ML_USERS * 8 / 1e9:.2f} GB): host {host:.3f} ms, "
        f"device {'not measured' if dev is None else f'{dev:.3f} ms'} "
        f"({card})")


def ratings_items(R, s21) -> dict:
  """learn.ALS (2 iterations, k = 64) on phase 21's ratings as a
  SparseArray, held to examples.als.fit with the same seed, and
  learn.TruncatedSVD(10) held to phase 21's svds values; returns the
  launches of K5a (the ALS estimator's) and of K3a/K3b (TruncatedSVD's)."""
  from spartan_tpu_torch import learn
  S = ingest_ratings(R)
  K5.reset_counts()
  with Timer() as t:
    est = learn.ALS(n_factors=ALS_K, iterations=ALS24_ITERS, reg=ALS_REG,
                    seed=0).fit(S)
  k5 = K5.counts["launches"]
  check(k5 == 2 * ALS24_ITERS and K5.counts["plain_runs"] == 0,
        f"learn.ALS launched K5a {k5} times, not {2 * ALS24_ITERS}")
  U, V = als.fit(S, k=ALS_K, iterations=ALS24_ITERS, reg=ALS_REG, seed=0)
  print(f"  learn.ALS k={ALS_K}, {ALS24_ITERS} iterations: {t.elapsed:.2f} s "
        f"(host clock); K5a launches {k5}")
  _held24("learn.ALS against als.fit", max(
      _rel(est.user_factors_, U), _rel(est.item_factors_, V)), 1e-6,
          "the same float32 products (bit-equal on repeat in phase 7)")
  KS.reset_counts()
  with Timer() as t:
    ts = learn.TruncatedSVD(n_components=SVDS_K, ncv=SVDS_NCV).fit(S)
  ell, csr = KS.counts["ell_launches"], KS.counts["csr_launches"]
  check(ell > 0 and csr > 0 and KS.counts["ell_plain_runs"] == 0
        and KS.counts["csr_plain_runs"] == 0,
        f"TruncatedSVD did not put its products on K3a/K3b ({KS.counts})")
  want = np.sort(s21)[::-1]
  got = ts.singular_values_
  smax = float(want.max())
  tol = 2 * (F32_TOL * smax ** 2 / want + 64 * EPS32 * smax)
  apart = np.abs(got - want)
  print(f"  learn.TruncatedSVD({SVDS_K}) of the ratings in "
        f"{t.elapsed:.2f} s: K3a {ell}, K3b {csr} launches; apart from "
        f"phase 21's svds {np.array2string(apart, precision=3)} (bound "
        "twice phase 21's tolerance: both lie within it of scipy's)")
  check(bool((apart <= tol).all()) and bool(np.all(np.diff(got) <= 0)),
        "TruncatedSVD disagrees with phase 21's svds")
  check(ts.components_.shape == (SVDS_K, ML_MOVIES),
        "TruncatedSVD's components' shape")
  del S, est, ts
  gc.collect()
  torch.cuda.empty_cache()
  return {"k5": k5, "ell": ell, "csr": csr}


def black_scholes_item(device, card: str, pool) -> None:
  """Black-Scholes on a book of 2^26 options drawn on the card, held to
  price_numpy on a seeded sample of 2^20 of them, the chain timed."""
  from spartan_tpu_torch.examples import black_scholes as bs
  gen = torch.Generator(device=device).manual_seed(P24_SEED)

  def uniform(lo, hi):
    return lo + (hi - lo) * torch.rand(BS_N, dtype=torch.float64,
                                       device=device, generator=gen)
  spot, strike, t = uniform(10.0, 200.0), uniform(10.0, 200.0), uniform(
      0.1, 2.0)
  args = [sp.Val(sp.SpartanArray(v)) for v in (spot, strike, t)]

  def price():
    return sp.evaluate(sp.ListExpr(list(bs.price(*args))))
  call, put = price()
  pick = torch.as_tensor(np.random.default_rng(P24_SEED).choice(
      BS_N, BS_SAMPLE, replace=False), device=device)
  host = [v[pick].cpu().numpy() for v in (spot, strike, t)]
  pending = pool.submit(bs.price_numpy, *host)
  ms = event_ms(price)[0]
  want_c, want_p = pending.result()
  err = max(float(np.abs(call.data[pick].cpu().numpy() - want_c).max()),
            float(np.abs(put.data[pick].cpu().numpy() - want_p).max()))
  print(f"  Black-Scholes: {BS_N} options priced in {ms:.3f} ms on the "
        f"card ({card}); the call and put of 5 float64 inputs and outputs "
        f"a {5 * 8 * BS_N / HBM_BYTES_PER_S * 1e3:.3f} ms pass of HBM")
  _held24("Black-Scholes against price_numpy on 2^20 options (absolute)",
          err, 1e-9, "the reference test's bound")


def _u(lo, hi):
  return ("u", lo, hi)


def _i(lo, hi):
  return ("i", lo, hi)


XP, XR, Y01 = _u(0.1, 5.0), _u(-4.0, 4.0), _u(0.01, 0.99)
# sp.special's device names: (name, arguments, keywords, rtol, atol) on
# the reference test's domains (``u``: uniform floats, ``i``: uniform
# integers, a number: a scalar); rtol/atol are the CPU test's bounds
SPECIAL_CASES = [
    ("gammaln", (XP,), {}, 1e-12, 1e-13), ("gamma", (XR,), {}, 1e-10, 1e-13),
    ("gammasgn", (XR,), {}, 0, 0), ("digamma", (XP,), {}, 1e-11, 1e-13),
    ("psi", (XP,), {}, 1e-11, 1e-13),
    ("rgamma", (XR,), {}, 1e-10, 1e-12),
    ("gammainc", (2.5, XP), {}, 1e-12, 1e-13),
    ("gammaincc", (2.5, XP), {}, 1e-12, 1e-13),
    ("multigammaln", (_u(3.1, 8.0), 3), {}, 1e-12, 1e-13),
    ("poch", (XP, 2.5), {}, 1e-11, 1e-13),
    ("beta", (XP, 2.0), {}, 1e-11, 1e-13),
    ("betaln", (XP, 2.0), {}, 1e-12, 1e-11),
    ("betainc", (2.0, 3.5, Y01), {}, 1e-12, 1e-13),
    ("erf", (XR,), {}, 1e-12, 1e-13), ("erfc", (XR,), {}, 1e-11, 1e-13),
    ("erfinv", (_u(-0.98, 0.98),), {}, 1e-11, 1e-13),
    ("erfcinv", (Y01,), {}, 1e-11, 1e-13),
    ("erfcx", (_u(-5.0, 25.0),), {}, 1e-12, 1e-13),
    ("ndtr", (XR,), {}, 1e-12, 1e-13), ("ndtri", (Y01,), {}, 1e-11, 1e-13),
    ("log_ndtr", (XR,), {}, 1e-12, 1e-13),
    ("gammaincinv", (2.5, Y01), {}, 1e-11, 1e-13),
    ("gammainccinv", (1.5, Y01), {}, 1e-11, 1e-13),
    ("betaincinv", (0.3, 8.0, Y01), {}, 1e-11, 1e-13),
    ("betainccinv", (2.0, 3.5, Y01), {}, 1e-11, 1e-13),
    # betainc's continued fraction over 2^16 points reaches 1.1e-12 (the
    # CPU test's 49 points: below 1e-12)
    ("stdtr", (4.0, _u(-6.0, 6.0)), {}, 1e-11, 1e-13),
    # t = sqrt(df (1 - x) / x) from x = betaincinv near 1 as p nears 0.5:
    # 1 - x cancels, an absolute error of about df eps / (2 |t|), the
    # reference's own there (1e-9 covers |t| >= 3e-7)
    ("stdtrit", (6.0, Y01), {}, 1e-11, 1e-9),
    ("chdtr", (3.0, XP), {}, 1e-12, 1e-13),
    ("chdtrc", (3.0, XP), {}, 1e-12, 1e-13),
    ("chdtri", (3.0, Y01), {}, 1e-11, 1e-13),
    ("fdtr", (3.0, 7.0, XP), {}, 1e-12, 1e-13),
    ("fdtrc", (3.0, 7.0, XP), {}, 1e-12, 1e-13),
    ("fdtri", (3.0, 7.0, Y01), {}, 1e-11, 1e-13),
    ("pdtr", (3, XP), {}, 1e-12, 1e-13), ("pdtrc", (3, XP), {}, 1e-12, 1e-13),
    ("pdtri", (3, Y01), {}, 1e-11, 1e-13),
    ("bdtr", (3, 10, Y01), {}, 1e-11, 1e-13),
    ("bdtrc", (3, 10, Y01), {}, 1e-11, 1e-13),
    ("bdtri", (3, 10, Y01), {}, 1e-11, 1e-13),
    ("nbdtr", (3, 5, Y01), {}, 1e-11, 1e-13),
    ("nbdtrc", (3, 5, Y01), {}, 1e-11, 1e-13),
    ("nbdtri", (3, 5, Y01), {}, 1e-11, 1e-13),
    ("gdtr", (2.0, 3.0, XP), {}, 1e-12, 1e-13),
    ("gdtrc", (2.0, 3.0, XP), {}, 1e-12, 1e-13),
    ("gdtrix", (2.0, 3.0, Y01), {}, 1e-11, 1e-13),
    ("kolmogorov", (_u(0.05, 2.5),), {}, 1e-12, 1e-14),
    ("kolmogi", (Y01,), {}, 1e-11, 1e-13),
    ("ellipk", (_u(-1.5, 0.99),), {}, 1e-12, 1e-13),
    ("ellipe", (_u(-1.5, 0.99),), {}, 1e-12, 1e-13),
    ("ellipkm1", (_u(1e-15, 0.8),), {}, 1e-12, 1e-13),
    ("agm", (XP, XP), {}, 1e-12, 1e-13),
    ("j0", (XP,), {}, 1e-10, 1e-13), ("j1", (XP,), {}, 1e-10, 1e-13),
    ("jn", (4, XP), {}, 1e-9, 1e-13),
    ("i0", (XR,), {}, 1e-11, 1e-13), ("i0e", (XR,), {}, 1e-11, 1e-13),
    ("i1", (XR,), {}, 1e-11, 1e-13), ("i1e", (XR,), {}, 1e-11, 1e-13),
    ("exp1", (XP,), {}, 1e-11, 1e-13), ("expi", (XR,), {}, 1e-11, 1e-13),
    ("expn", (_i(0, 5), _u(0.1, 10.0)), {}, 1e-11, 1e-13),
    ("sici", (XP,), {}, 1e-11, 1e-13),
    ("fresnel", (XR,), {}, 0, 1e-12),
    ("cosm1", (_u(-0.2, 0.2),), {}, 1e-12, 1e-13),
    ("powm1", (XP, XR), {}, 1e-11, 1e-13),
    ("exprel", (_u(-2.0, 2.0),), {}, 1e-12, 1e-13),
    ("exp2", (XR,), {}, 1e-12, 1e-13), ("exp10", (XR,), {}, 1e-12, 1e-13),
    ("cbrt", (XR,), {}, 1e-12, 1e-13), ("log1p", (XP,), {}, 1e-12, 1e-13),
    ("expm1", (XR,), {}, 1e-12, 1e-13), ("expit", (XR,), {}, 1e-12, 1e-13),
    ("logit", (Y01,), {}, 1e-12, 1e-13),
    ("log_expit", (XR,), {}, 1e-12, 1e-13),
    ("logaddexp", (XR, XP), {}, 1e-12, 1e-13),
    ("softplus", (XR,), {}, 1e-12, 1e-13),
    ("xlogy", (XR, XP), {}, 1e-12, 1e-13),
    ("xlog1py", (XR, XP), {}, 1e-12, 1e-13),
    ("entr", (XP,), {}, 1e-12, 1e-13),
    ("rel_entr", (XP, XP), {}, 1e-12, 1e-13),
    ("kl_div", (XP, XP), {}, 1e-12, 1e-13),
    ("huber", (1.2, XR), {}, 1e-12, 1e-13),
    ("pseudo_huber", (1.2, XR), {}, 1e-12, 1e-13),
    ("boxcox", (XP, 0.37), {}, 1e-12, 1e-13),
    ("boxcox1p", (XP, 0.37), {}, 1e-12, 1e-13),
    ("inv_boxcox", (XP, 0.37), {}, 1e-11, 1e-13),
    ("inv_boxcox1p", (XP, 0.37), {}, 1e-11, 1e-13),
    ("sindg", (_u(-200.0, 200.0),), {}, 0, 1e-12),
    ("cosdg", (_u(-200.0, 200.0),), {}, 0, 1e-12),
    ("tandg", (_u(-80.0, 80.0),), {}, 1e-10, 1e-13),
    ("cotdg", (_u(5.0, 175.0),), {}, 1e-10, 1e-13),
    ("radian", (_u(0.0, 360.0), _u(0.0, 60.0), _u(0.0, 60.0)), {}, 1e-12,
     1e-13),
    ("diric", (_u(-7.0, 7.0), 6), {}, 0, 1e-12),
    ("zetac", (_u(1.5, 30.0),), {}, 1e-10, 1e-13),
    ("zeta", (_u(1.5, 10.0), 2.0), {}, 1e-11, 1e-13),
    ("spence", (XP,), {}, 1e-11, 1e-13),
    ("softmax", ("m",), {"axis": 1}, 1e-12, 1e-13),
    ("log_softmax", ("m",), {"axis": 1}, 1e-12, 1e-13),
    ("logsumexp", ("m",), {"axis": 1}, 1e-12, 1e-13),
    ("comb", (_i(0, 30), 3), {}, 1e-12, 1e-13),
    ("perm", (_i(0, 30), 3), {}, 1e-12, 1e-13),
    ("binom", (_u(0.3, 15.0), XP), {}, 1e-11, 1e-13),
    ("factorial", (_i(0, 20),), {}, 1e-12, 1e-13),
    ("factorial2", (_i(0, 25),), {}, 1e-12, 1e-13),
    ("eval_legendre", (7, _u(-1.0, 1.0)), {}, 0, 1e-13),
    ("eval_chebyt", (7, _u(-1.0, 1.0)), {}, 0, 1e-12),
    ("eval_chebyu", (7, _u(-1.0, 1.0)), {}, 0, 1e-12),
    # near a root the recurrence keeps a few ulps of its largest term
    # (about 2e7 for H_7 at |x| <= 4, 2e4 for He_7) and no relative digit
    ("eval_hermite", (7, XR), {}, 1e-11, 1e-8),
    ("eval_hermitenorm", (7, XR), {}, 1e-11, 1e-11),
    ("eval_laguerre", (7, XP), {}, 1e-11, 1e-12),
    ("eval_genlaguerre", (5, 1.3, XP), {}, 1e-10, 1e-12),
    ("eval_gegenbauer", (5, 0.7, _u(-1.0, 1.0)), {}, 1e-10, 1e-12),
    ("hyp1f1", (1.5, 2.5, XR), {}, 1e-3, 1e-13),
    ("hyp2f1", (1.2, 0.7, 2.5, Y01), {}, 1e-3, 1e-13),
    ("polygamma", (_i(0, 3), XP), {}, 1e-11, 1e-13),
    ("sph_harm_y", (_i(0, 8), _i(-8, 8), _u(0.01, 3.13), _u(0.0, 6.28)), {},
     1e-12, 1e-13),
]
SPECIAL_ORACLES = {"logaddexp": np.logaddexp}
# inverses the reference's test checks by a round trip
SPECIAL_ROUND_TRIPS = {"inv_boxcox": "boxcox", "inv_boxcox1p": "boxcox1p"}
# the direct core's float32 pass: (name, arguments), held to scipy's float64
# of the float32 inputs at 2e-4 relative with a floor of 2e-5 of the largest
# value (float32's rounding through a few operations; the CPU test's bounds)
SPECIAL_F32 = [("gamma", (XP,)), ("gammaln", (XP,)), ("digamma", (XP,)),
               ("gammainc", (XP, XP)), ("beta", (XP, XP)),
               ("betainc", (XP, XP, Y01)), ("erf", (XR,)), ("erfc", (XR,)),
               ("erfinv", (_u(-0.98, 0.98),)), ("ndtr", (XR,)),
               ("ndtri", (Y01,)), ("log_ndtr", (XR,)), ("expit", (XR,)),
               ("logit", (Y01,)), ("entr", (XP,)), ("xlogy", (XR, XP)),
               ("exp1", (XP,)), ("expi", (XP,)), ("i0", (XR,)),
               ("i1e", (XR,)), ("zeta", (_u(1.6, 6.5), XP)),
               ("poch", (XP, XP)), ("hyp1f1", (1.5, 2.5, XR)),
               ("spence", (XP,))]


def special_args(spec, n: int, dtype, gen, device):
  """The card's arguments of a case: each ``u``/``i`` spec drawn at ``n``
  points (``m``: a square matrix of n points), scalars as they are."""
  out = []
  side = int(round(n ** 0.5))
  for a in spec:
    if isinstance(a, tuple) and a[0] == "u":
      out.append(a[1] + (a[2] - a[1]) * torch.rand(
          n, dtype=dtype, device=device, generator=gen))
    elif isinstance(a, tuple) and a[0] == "i":
      out.append(torch.randint(a[1], a[2] + 1, (n,), device=device,
                               generator=gen))
    elif a == "m":
      out.append(torch.randn((side, side), dtype=dtype, device=device,
                             generator=gen))
    else:
      out.append(a)
  return out


def special_sample(args, pick, rows):
  """The sampled host copies of a case's arguments (whole rows for a
  matrix)."""
  out = []
  for a in args:
    if isinstance(a, torch.Tensor):
      out.append((a[rows] if a.ndim == 2 else a[pick]).cpu().numpy())
    else:
      out.append(a)
  return out


def special_scipy(name, host, kw):
  import scipy.special as ssp
  if name in SPECIAL_ROUND_TRIPS:
    return host[0]
  return getattr(ssp, name, SPECIAL_ORACLES.get(name))(*host, **kw)


def _special_err(got, want, rtol, atol) -> float:
  """The worst |got - want| over (atol + rtol |want|): <= 1 passes."""
  got, want = np.asarray(got), np.asarray(want)
  bad = np.isnan(got) != np.isnan(want)
  g = np.nan_to_num(got, nan=0.0, posinf=0.0, neginf=0.0)
  w = np.nan_to_num(want, nan=0.0, posinf=0.0, neginf=0.0)
  inf_apart = np.isinf(got) != np.isinf(want)
  if bad.any() or inf_apart.any():
    return np.inf
  lim = atol + rtol * np.abs(w)
  diff = np.abs(g - w)
  return float(np.max(np.where(lim > 0, diff / np.where(lim > 0, lim, 1),
                               np.where(diff > 0, np.inf, 0.0))))


def special_items(device, card: str, pool) -> None:
  """Every device name of sp.special at 2^24 float64 points of its domain
  (the betainc/kolmogorov inverses at 2^18; betaincinv, betainccinv,
  stdtrit and fdtri in phase 25 instead), each held to scipy on a seeded
  sample of 2^16 of those points (whole rows of the 4096 x 4096 matrix for
  the reductions), scipy computed on host threads; the direct core again
  in float32; four names timed; every host name once through the counted
  boundary."""
  from spartan_tpu_torch import special
  from spartan_tpu_torch.expr import fio
  S = sp.special
  gen = torch.Generator(device=device).manual_seed(P24_SEED)
  rng = np.random.default_rng(P24_SEED)
  names = {c[0] for c in SPECIAL_CASES}
  check(names == set(special.__all__) - set(special._HOST_NAMES),
        "phase 24's special cases are not the device names")
  worst, pending, times, walls = [], [], {}, {}
  special.counts.update(reads=0, turns=0)
  t0 = time.perf_counter()
  for name, spec, kw, rtol, atol in SPECIAL_CASES:
    if name in SPECIAL_IN_PHASE25 or name in SPECIAL_OFF_CARD:
      continue
    n = SPECIAL_SLOW_N if name in SPECIAL_SLOW else SPECIAL_N
    drawn = special_args(spec, n, torch.float64, gen, device)
    args = drawn
    if name in SPECIAL_ROUND_TRIPS:  # inv_boxcox(boxcox(x)) against x
      args = [getattr(S, SPECIAL_ROUND_TRIPS[name])(*drawn).evaluate(),
              drawn[1]]
    fn = getattr(S, name)
    t_name = time.perf_counter()

    def outputs():
      out = fn(*args, **kw)
      outs = out if isinstance(out, tuple) else (out,)
      check(all(isinstance(o, sp.Expr) for o in outs), f"{name} is not lazy")
      return [o.evaluate().data for o in outs]
    res = outputs()
    if name in SPECIAL_TIMED:
      times[name] = event_ms(outputs)[0]
    pick = torch.as_tensor(rng.choice(n, min(n, SPECIAL_SAMPLE),
                                      replace=False), device=device)
    rows = torch.as_tensor(rng.choice(int(round(n ** 0.5)), 16,
                                      replace=False), device=device)
    host = special_sample(drawn, pick, rows)
    # a reduction's rows (its output along axis 1 or the whole row)
    got = [(r[rows] if "m" in spec else r[pick]).cpu().numpy() for r in res]
    pending.append((name, rtol, atol, got,
                    pool.submit(special_scipy, name, host, kw)))
    walls[name] = time.perf_counter() - t_name
    del drawn, args, res
  wall = time.perf_counter() - t0
  for name, rtol, atol, got, fut in pending:
    want = fut.result()
    want = want if isinstance(want, tuple) else (want,)
    worst.append((max(_special_err(g, w, rtol, atol)
                      for g, w in zip(got, want)), name))
  worst.sort(reverse=True)
  print(f"  sp.special: {len(pending)} device names at {SPECIAL_N} "
        f"float64 points ({', '.join(n for n in SPECIAL_SLOW if n not in SPECIAL_IN_PHASE25 + SPECIAL_OFF_CARD)} at "
        f"{SPECIAL_SLOW_N}; {', '.join(SPECIAL_IN_PHASE25)} in phase 25; "
        f"{', '.join(SPECIAL_OFF_CARD)} on the CPU only) in "
        f"{wall:.2f} s; converging loops read the host "
        f"{special.counts['reads']} times over {special.counts['turns']} "
        "turns; the largest error over its bound (atol + rtol |scipy|, the "
        "CPU test's bounds but where SPECIAL_CASES widens one; <= 1 "
        "passes): " + ", ".join(
            f"{name} {err:.3g}" for err, name in worst[:8]))
  print("  the longest names (host clock, the sample and its copy "
        "included): " + ", ".join(f"{n} {w:.2f} s" for n, w in sorted(
            walls.items(), key=lambda kv: -kv[1])[:10]))
  check(worst[0][0] <= 1.0, f"sp.special.{worst[0][1]} strays from scipy "
        f"({worst[0][0]:.3g} of its bound)")
  print("  ms at 2^24 float64 points (CUDA events; betainc and hyp1f1 "
        "read the host every 8 turns, which the time includes) (" + card
        + "): " + ", ".join(
      f"{name} {times[name]:.3f}" for name in SPECIAL_TIMED))
  worst32 = []
  for name, spec in SPECIAL_F32:
    args = special_args(spec, SPECIAL_N, torch.float32, gen, device)
    res = getattr(S, name)(*args).evaluate().data
    check(res.dtype == torch.float32, f"{name} of float32 is {res.dtype}")
    pick = torch.as_tensor(rng.choice(SPECIAL_N, SPECIAL_SAMPLE,
                                      replace=False), device=device)
    host = [a.astype(np.float64) if isinstance(a, np.ndarray) else a
            for a in special_sample(args, pick, None)]
    want = special_scipy(name, host, {})
    got = res[pick].double().cpu().numpy()
    worst32.append((_special_err(got, want, 2e-4,
                                 2e-5 * float(np.abs(want).max())), name))
  worst32.sort(reverse=True)
  print("  float32 pass of the direct core at 2^24: the largest error over "
        "its bound: " + ", ".join(f"{name} {err:.3g}"
                                  for err, name in worst32[:5]))
  check(worst32[0][0] <= 1.0, f"float32 sp.special.{worst32[0][1]} strays")
  # every host name once through the counted boundary: scipy's module is
  # swapped for one that records the call, the operand an expr on the card
  calls = []

  class Recorder:
    def __getattr__(self, name):
      def record(*a, **k):
        calls.append((name, np.asarray(a[0]).tolist()))
        return name
      return record
  wrapped = [n for n in special._HOST_NAMES
             if not isinstance(getattr(S, n), type)]
  before = fio.counts["host_runs"]
  real = special._ss
  special._ss = Recorder()
  try:
    operand = sp.from_numpy(np.array([0.5, 1.5]))
    for n in wrapped:
      check(getattr(S, n)(operand) == n, f"sp.special.{n}'s boundary")
  finally:
    special._ss = real
  counted = fio.counts["host_runs"] - before
  import scipy.special as ssp
  xp = np.linspace(0.5, 4.0, 9)
  for a, w in zip(S.airy(sp.from_numpy(xp)), ssp.airy(xp)):
    check(np.allclose(a, w, rtol=1e-12, atol=0), "sp.special.airy")
  check(np.allclose(S.struve(0, xp), ssp.struve(0, xp), rtol=1e-12)
        and np.allclose(S.yn(1, sp.from_numpy(xp)), ssp.yn(1, xp),
                        rtol=1e-12), "sp.special.struve/yn")
  counted_real = fio.counts["host_runs"] - before - counted
  print(f"  sp.special's {len(wrapped)} wrapped host names each once: "
        f"{counted} host runs, each called with its expr operand on the "
        f"host; airy, struve and yn against scipy: {counted_real} more")
  check(counted == len(wrapped) == len(calls)
        and all(c == [0.5, 1.5] for _, c in calls) and counted_real == 3,
        "the host boundary's count")


def cli_start():
  """``python -m spartan_tpu_torch.examples knn`` as a subprocess on the
  card, started here and read by :func:`cli_items` (a fresh process pays
  its first CUDA use while this one works)."""
  return time.perf_counter(), subprocess.Popen(
      [sys.executable, "-m", "spartan_tpu_torch.examples", "knn"],
      stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
      cwd=pathlib.Path(__file__).parent)


def cli_items(card: str, started) -> None:
  """Every registered runner of the examples' CLI in this process at its
  own size, then the subprocess of :func:`cli_start`: exit 0 and the
  reference's keys."""
  import ast

  from spartan_tpu_torch.examples.__main__ import _RUNNERS, WAITING
  t0 = time.perf_counter()
  secs = {}
  for name, runner in sorted(_RUNNERS.items()):
    t = time.perf_counter()
    out = runner()
    secs[name] = time.perf_counter() - t
    check(isinstance(out, dict) and out, f"runner {name} returned {out!r}")
  print(f"  {len(_RUNNERS)} runners in {time.perf_counter() - t0:.2f} s "
        f"(waiting: {', '.join(n for n, _ in WAITING)}); the slowest: "
        + ", ".join(f"{n} {s:.2f} s" for n, s in sorted(
            secs.items(), key=lambda kv: -kv[1])[:4]))
  t_start, proc = started
  stdout, stderr = proc.communicate(timeout=300)
  last = stdout.strip().splitlines()[-1] if stdout.strip() else ""
  print(f"  python -m spartan_tpu_torch.examples knn: exit {proc.returncode} "
        f"{time.perf_counter() - t_start:.2f} s after its start: {last}")
  check(proc.returncode == 0, f"the CLI failed: {stderr[-2000:]}")
  out = ast.literal_eval(last)
  check(set(out) == {"accuracy", "seconds", "example", "mesh"}
        and out["accuracy"] > 0.95, f"the CLI printed {out}")


def phase_learn_special(device, card: str, oracles: dict, procs, R,
                        s21) -> dict:
  """Phase 24: the remaining examples through learn's estimators at full
  width, sp.special at 2^24 points and the CLI; returns the launches of
  K5a and K3a/K3b its ratings items counted."""
  from spartan_tpu_torch.expr import fio
  t0 = time.perf_counter()
  runs = fio.counts["host_runs"]
  ORACLE_WAIT[0] = 0.0

  def since(what: str) -> None:
    print(f"  [{time.perf_counter() - t0:.2f} s into phase 24: {what}]")

  cli = cli_start()
  gmm = gmm_start(procs)  # its oracle runs in a worker meanwhile
  pool = concurrent.futures.ThreadPoolExecutor(max_workers=6)
  with pool:
    regression_items(device, card, oracles)
    since("the regressions")
    knn_item(card, oracles)
    naive_bayes_item(device, pool)
    since("k-NN and naive Bayes")
    netflix_items(device, card)
    since("netflix SGD")
    gc.collect()
    torch.cuda.empty_cache()
    launches = ratings_items(R, s21)
    since("ALS and TruncatedSVD on the ratings")
    black_scholes_item(device, card, pool)
    clustering_items(device, card, gmm)
    del gmm
    since("Black-Scholes and the clustering")
    gc.collect()
    torch.cuda.empty_cache()
    special_items(device, card, pool)
    since("sp.special")
  gc.collect()
  torch.cuda.empty_cache()
  cli_items(card, cli)
  host_runs = fio.counts["host_runs"] - runs
  print(f"  phase 24 host_runs {host_runs}; "
        f"{time.perf_counter() - t0:.2f} s, {ORACLE_WAIT[0]:.2f} s of it "
        "waiting for the oracle processes")
  return launches


# phase 25: sp.stats and sp.signal at full width, and the oscillator.
# Cuts, each for the phase's time (it aims at 30-40 s of the script's 1200):
# the ppf/isf of t, f and beta and the cdf/ppf of binom and nbinom run at
# 2^16 points, not 2^22 (each bisection step calls betainc's continued
# fraction, 64-180 steps of about 10^3 launches), and so do the draws of t,
# f and beta (they go through the same ppf).
P25_SEED = 25
DIST_N, DIST_SLOW_N, DIST_SAMPLE = 1 << 22, 1 << 16, 1 << 16
RVS_N = 1 << 22
RVS_ALPHA = 1e-6
DESC_SHAPE = (1 << 14, 1 << 10)
DESC_SAMPLE = 1 << 16
TEST_N = 1 << 20
KDE_N, KDE_POINTS, KDE_SAMPLE = 4096, 1 << 16, 1 << 12
CONV_N, CONV_TAPS = 1 << 20, 255
FFTCONV_N, FFTCONV_TAPS = 1 << 22, 4095
CONV2_SIDE, CONV2_K = 4096, 7
SPEC_N, SPEC_SEG = 1 << 22, 1024
MED2_SIDE = 2048
LS_N, LS_F = 1 << 14, 1 << 12
FILT_CH, LF_N, SOS_N = 256, 1 << 14, 1 << 12
LF_PROF = (1 << 11, 1 << 10)  # the profiled lfilter passes' samples
SIG_SAMPLE = 1 << 16

# (name, shape parameters, loc, scale, low z, high z): points z on
# [low, high] of the standardized variable, x = loc + scale z
DIST_CASES = [
    ("norm", (), 0.5, 1.7, -6.0, 6.0),
    ("t", (5.0,), 0.3, 1.5, -8.0, 8.0),
    ("chi2", (4.0,), 0.2, 2.0, 0.01, 25.0),
    ("gamma", (2.5,), 0.1, 1.3, 0.01, 20.0),
    ("beta", (2.0, 3.0), -0.5, 2.0, 0.001, 0.999),
    ("f", (4.0, 9.0), 0.1, 1.2, 0.01, 10.0),
    ("expon", (), 0.4, 2.0, 0.0, 15.0),
    ("uniform", (), 1.0, 3.0, 0.0, 1.0),
    ("laplace", (), 0.2, 1.1, -10.0, 10.0),
    ("logistic", (), -0.3, 0.8, -15.0, 15.0),
    ("cauchy", (), 0.5, 1.3, -50.0, 50.0),
    ("lognorm", (0.8,), 0.1, 1.5, 0.01, 15.0),
    ("gumbel_r", (), 0.3, 1.2, -2.0, 12.0),
    ("gumbel_l", (), -0.2, 0.9, -12.0, 2.0),
    ("pareto", (2.5,), 0.1, 0.7, 1.001, 50.0),
    ("weibull_min", (1.7,), 0.2, 1.4, 0.01, 5.0),
    ("rayleigh", (), 0.1, 1.6, 0.01, 6.0),
    ("halfnorm", (), -0.4, 1.2, 0.0, 5.0),
    ("truncnorm", (-1.0, 2.0), 0.3, 1.4, -1.0, 2.0),
    ("poisson", (3.5,), 2.0, None, 0, 15),
    ("binom", (12.0, 0.3), 1.0, None, 0, 12),
    ("nbinom", (5.0, 0.4), 0.0, None, 0, 30),
    ("geom", (0.3,), -1.0, None, 1, 20),
    ("bernoulli", (0.4,), 0.0, None, 0, 1),
]
# the cases whose ppf (and isf, or cdf for the discrete) bisect through
# betainc: run at DIST_SLOW_N
DIST_SLOW = {("t", "ppf"), ("t", "isf"), ("f", "ppf"), ("f", "isf"),
             ("beta", "ppf"), ("beta", "isf"), ("binom", "cdf"),
             ("binom", "ppf"), ("nbinom", "cdf"), ("nbinom", "ppf")}
# trimmed for phase 26's time: one bisection method of each of the five
# distributions stays on the card (t.ppf, f.isf, beta.ppf, binom.cdf,
# nbinom.ppf; the moments' ppf levels and the draws of t, f and beta bisect
# too); tests/test_torch_stats.py holds these five against scipy on the
# CPU, and the card test test_stats_inverses_and_normal_tail_on_card t.ppf
# and binom.cdf
DIST_OFF_CARD = {("t", "isf"), ("f", "ppf"), ("beta", "isf"),
                 ("binom", "ppf"), ("nbinom", "cdf")}
CONT_METHODS = ("logpdf", "pdf", "cdf", "sf", "logcdf", "logsf", "ppf",
                "isf")
DISC_METHODS = ("logpmf", "pmf", "cdf", "sf", "ppf")
DEVICE_ENTROPY = ("norm", "gamma", "expon", "uniform", "laplace",
                  "logistic", "cauchy", "gumbel_r", "gumbel_l", "bernoulli")
# (rtol, atol) a method; the logs of the tails take an absolute bound (a
# complement 1 - cdf near 1 keeps about 1e-16 absolute)
DIST_TOL = {"logpdf": (1e-9, 1e-12), "pdf": (1e-9, 1e-13),
            "logpmf": (1e-9, 1e-12), "pmf": (1e-9, 1e-13),
            "cdf": (1e-9, 1e-13), "sf": (1e-9, 1e-13),
            "logcdf": (1e-9, 1e-9), "logsf": (1e-9, 1e-9),
            "ppf": (1e-8, 1e-10), "isf": (1e-8, 1e-10),
            "moments": (1e-10, 1e-13)}


def _dist_args(case):
  name, shape, loc, scale = case[:4]
  return shape + ((loc,) if scale is None else (loc, scale))


def dist_points(case, n):
  """(x, q) of a case: n points of its support (integers for a discrete
  one) and n levels in (1e-3, 1 - 1e-3), NumPy's draw from the seed."""
  name, shape, loc, scale, lo, hi = case
  rx, rq = (np.random.default_rng([P25_SEED, DIST_CASES.index(case), i])
            for i in (0, 1))
  if scale is None:
    x = rx.integers(lo, hi + 1, n).astype(np.float64) + loc
  else:
    x = loc + scale * rx.uniform(lo, hi, n)
  return x, rq.uniform(1e-3, 1 - 1e-3, n)


def dist_oracle() -> dict:
  """scipy.stats on the first DIST_SAMPLE points of each case (a worker
  process)."""
  import scipy.stats as sst
  out = {}
  for case in DIST_CASES:
    name, scale = case[0], case[3]
    x, q = dist_points(case, DIST_SAMPLE)
    d = getattr(sst, name)
    a = _dist_args(case)
    for m in (DISC_METHODS if scale is None else CONT_METHODS):
      out[name, m] = getattr(d, m)(q if m in ("ppf", "isf") else x, *a)
    out[name, "moments"] = np.array(
        [d.mean(*a), d.var(*a), d.std(*a), d.median(*a),
         *d.interval(0.9, *a),
         d.entropy(*a) if name in DEVICE_ENTROPY else np.nan])
    out[name, "kurtosis"] = float(d.stats(*a, moments="k"))
  return out


def desc_data():
  """The descriptive statistics' matrices (2^14 x 2^10 float64): normal
  M, lognormal P (positive), rounded R (ties), E (positive weights)."""
  rng = np.random.default_rng([P25_SEED, 100])
  M = rng.standard_normal(DESC_SHAPE) * 1.5 + 0.5
  return {"M": M, "P": np.exp(0.3 * M), "R": np.round(M * 2),
          "E": np.abs(M) + 0.1}


# (label, function, data, keyword arguments)
DESC_CASES = [
    ("moment3", "moment", "M", {"order": 3}),
    ("skew", "skew", "M", {}), ("skew_unbiased", "skew", "M", {"bias": False}),
    ("kurtosis", "kurtosis", "M", {}),
    ("kurtosis_unbiased", "kurtosis", "M", {"bias": False}),
    ("gmean", "gmean", "P", {}), ("hmean", "hmean", "P", {}),
    ("pmean", "pmean", "P", {"p": 2.5}), ("sem", "sem", "M", {}),
    ("zscore", "zscore", "M", {}), ("gzscore", "gzscore", "P", {}),
    ("iqr", "iqr", "M", {}), ("mad", "median_abs_deviation", "M", {}),
    ("variation", "variation", "P", {}),
    ("tmean", "tmean", "M", {"limits": (-1.0, 2.0)}),
    ("tvar", "tvar", "M", {"limits": (-1.0, 2.0)}),
    ("tstd", "tstd", "M", {"limits": (-1.0, 2.0)}),
    ("tsem", "tsem", "M", {"limits": (-1.0, 2.0)}),
    ("tmin", "tmin", "M", {"lowerlimit": -1.0}),
    ("tmax", "tmax", "M", {"upperlimit": 2.0}),
    ("trim_mean", "trim_mean", "M", {"proportiontocut": 0.1}),
    ("mode", "mode", "R", {}), ("rankdata", "rankdata", "R", {}),
    ("entropy", "entropy", "E", {}), ("circmean", "circmean", "M", {}),
    ("circvar", "circvar", "M", {}), ("circstd", "circstd", "M", {}),
    ("gstd", "gstd", "P", {}), ("describe", "describe", "M", {}),
]
DESC_AXES = (0, 1, None)


def _desc_flat(out):
  """A result as a list of float64 arrays (tuples flattened)."""
  if isinstance(out, tuple):
    return [a for o in out for a in _desc_flat(o)]
  return [np.asarray(out, dtype=np.float64).reshape(-1)]


def desc_pick(size: int) -> np.ndarray:
  return np.random.default_rng([P25_SEED, 101]).choice(
      size, min(size, DESC_SAMPLE), replace=False)


def desc_oracle() -> dict:
  """scipy.stats's descriptive statistics of desc_data along 0, 1 and None
  (a worker process); a result longer than DESC_SAMPLE is sampled."""
  import scipy.stats as sst
  data = desc_data()
  out = {}
  for label, fn, key, kw in DESC_CASES:
    for ax in DESC_AXES:
      res = getattr(sst, fn)(data[key], axis=ax, **kw)
      if fn == "describe":
        res = (res.nobs, res.minmax, res.mean, res.variance, res.skewness,
               res.kurtosis)
      flat = _desc_flat(res)
      out[label, ax] = [f[desc_pick(f.size)] if f.size > DESC_SAMPLE else f
                        for f in flat]
  return out


def test_data():
  """The hypothesis tests' 2^20-sample vectors: x, y (y = 0.5 x + noise),
  z (shifted), their rounded copies (ties for the rank tests), observed
  and expected counts and p-values."""
  rng = np.random.default_rng([P25_SEED, 200])
  x = rng.standard_normal(TEST_N)
  y = 0.5 * x + rng.standard_normal(TEST_N)
  z = rng.standard_normal(TEST_N) + 0.002
  fe = rng.uniform(50.0, 150.0, 4096)
  fo = np.round(fe + rng.standard_normal(4096) * np.sqrt(fe))
  fe = fe * fo.sum() / fe.sum()
  return {"x": x, "y": y, "z": z, "xr": np.round(x * 4),
          "yr": np.round(y * 4), "zr": np.round(z * 4), "fo": fo, "fe": fe,
          "pv": rng.uniform(0.01, 1.0, 4096)}


def _test_calls(S, d):
  """The tests as (label, thunk) over the module ``S`` (sp.stats or
  scipy.stats) and the data ``d``."""
  mw = {"method": "asymptotic"} if S.__name__ == "scipy.stats" else {}
  return [
      ("ttest_1samp", lambda: S.ttest_1samp(d["x"], 0.001)),
      ("ttest_ind", lambda: S.ttest_ind(d["x"], d["z"])),
      ("ttest_welch", lambda: S.ttest_ind(d["x"], d["y"], equal_var=False)),
      ("ttest_rel", lambda: S.ttest_rel(d["x"], d["z"])),
      ("pearsonr", lambda: S.pearsonr(d["x"], d["y"])),
      ("spearmanr", lambda: S.spearmanr(d["xr"], d["yr"])),
      ("chisquare", lambda: S.chisquare(d["fo"], d["fe"])),
      ("f_oneway", lambda: S.f_oneway(d["x"], d["y"], d["z"])),
      ("bartlett", lambda: S.bartlett(d["x"], d["y"], d["z"])),
      ("levene", lambda: S.levene(d["x"], d["y"], d["z"])),
      ("skewtest", lambda: S.skewtest(d["x"])),
      ("kurtosistest", lambda: S.kurtosistest(d["x"])),
      ("normaltest", lambda: S.normaltest(d["x"])),
      ("jarque_bera", lambda: S.jarque_bera(d["x"])),
      ("mannwhitneyu", lambda: S.mannwhitneyu(d["xr"], d["zr"], **mw)),
      ("ranksums", lambda: S.ranksums(d["xr"], d["zr"])),
      ("kruskal", lambda: S.kruskal(d["xr"], d["yr"], d["zr"])),
      ("combine_fisher", lambda: S.combine_pvalues(d["pv"])),
      ("combine_stouffer",
       lambda: S.combine_pvalues(d["pv"], method="stouffer")),
      ("linregress", lambda: S.linregress(d["x"], d["y"])),
      ("ks_2samp", lambda: S.ks_2samp(d["x"], d["z"])),
      ("kstest", lambda: S.kstest(d["x"], "norm")),
  ]


def _test_values(res):
  if hasattr(res, "intercept_stderr"):
    return [float(res.slope), float(res.intercept), float(res.rvalue),
            float(res.pvalue), float(res.stderr),
            float(res.intercept_stderr)]
  return [float(np.asarray(res.statistic)), float(np.asarray(res.pvalue))]


def test_oracle() -> dict:
  import scipy.stats as sst
  return {label: _test_values(fn())
          for label, fn in _test_calls(sst, test_data())}


def kde_data():
  rng = np.random.default_rng([P25_SEED, 300])
  cov = np.array([[1.0, 0.3, 0.1], [0.3, 2.0, -0.4], [0.1, -0.4, 0.5]])
  ds = rng.multivariate_normal([0.0, 1.0, -1.0], cov, KDE_N).T
  pts = rng.multivariate_normal([0.0, 1.0, -1.0], 1.5 * cov, KDE_POINTS).T
  return ds, pts


def kde_oracle() -> dict:
  import scipy.stats as sst
  ds, pts = kde_data()
  k = sst.gaussian_kde(ds)
  return {"evaluate": k.evaluate(pts[:, :KDE_SAMPLE]),
          "logpdf": k.logpdf(pts[:, :KDE_SAMPLE]),
          "gauss": k.integrate_gaussian(np.array([0.2, 0.8, -0.9]),
                                        np.eye(3) * 0.5)}


def signal_data():
  """The convolution, spectral and resampling inputs (NumPy's draws)."""
  rng = np.random.default_rng([P25_SEED, 400])
  t = np.arange(SPEC_N) / 1000.0
  return {"x": rng.standard_normal(CONV_N),
          "h": rng.standard_normal(CONV_TAPS),
          "xl": rng.standard_normal(FFTCONV_N),
          "hl": rng.standard_normal(FFTCONV_TAPS),
          "img": rng.standard_normal((CONV2_SIDE, CONV2_SIDE)),
          "k2": rng.standard_normal((CONV2_K, CONV2_K)),
          "s": np.sin(2 * np.pi * 50.0 * t) + rng.standard_normal(SPEC_N),
          "s2": np.cos(2 * np.pi * 50.0 * t + 0.3)
          + rng.standard_normal(SPEC_N),
          "m2": rng.standard_normal((MED2_SIDE, MED2_SIDE)),
          "lt": (lt := np.sort(rng.uniform(0, 100.0, LS_N))),
          "ly": np.sin(2 * np.pi * 0.7 * lt) + rng.standard_normal(LS_N),
          "lf": np.linspace(0.05, 20.0, LS_F)}


def sig_pick(size: int) -> np.ndarray:
  return np.random.default_rng([P25_SEED, 401]).choice(
      size, min(size, SIG_SAMPLE), replace=False)


def _sig_calls(S, d):
  """(label, thunk) of the signal items over ``S`` (sp.signal or
  scipy.signal)."""
  sc = S.__name__ == "scipy.signal"
  return [
      ("convolve", lambda: S.convolve(d["x"], d["h"], method="direct")
       if not sc else S.convolve(d["x"], d["h"])),
      ("correlate", lambda: S.correlate(d["x"], d["h"], mode="same")),
      ("fftconvolve", lambda: S.fftconvolve(d["xl"], d["hl"])),
      ("convolve2d", lambda: S.convolve2d(d["img"], d["k2"], mode="same")
       if not sc else S.fftconvolve(d["img"], d["k2"], mode="same")),
      ("welch", lambda: S.welch(d["s"], fs=1000.0, nperseg=SPEC_SEG)[1]),
      ("csd", lambda: S.csd(d["s"], d["s2"], fs=1000.0,
                            nperseg=SPEC_SEG)[1]),
      ("coherence", lambda: S.coherence(d["s"], d["s2"], fs=1000.0,
                                        nperseg=SPEC_SEG)[1]),
      ("periodogram", lambda: S.periodogram(d["s"], fs=1000.0)[1]),
      ("spectrogram", lambda: S.spectrogram(d["s"], fs=1000.0,
                                            nperseg=SPEC_SEG)[2]),
      ("stft", lambda: S.stft(d["s"], fs=1000.0, nperseg=SPEC_SEG)[2]),
      ("hilbert", lambda: S.hilbert(d["x"])),
      ("resample", lambda: S.resample(d["x"], 3 * CONV_N // 4)),
      ("resample_poly", lambda: S.resample_poly(d["x"], 3, 2)),
      ("savgol", lambda: S.savgol_filter(d["x"], 31, 3)),
      ("medfilt", lambda: S.medfilt(d["x"], 5)),
      ("medfilt2d", lambda: S.medfilt2d(d["m2"], 3)),
      ("lombscargle", lambda: S.lombscargle(d["lt"], d["ly"], d["lf"])),
      ("czt", lambda: S.czt(d["x"][:1 << 16], m=1 << 12,
                            w=np.exp(-2j * np.pi / 8192.0))),
      ("detrend", lambda: S.detrend(d["xl"])),
      ("square", lambda: S.square(d["xl"] * 10, 0.3)),
      ("sawtooth", lambda: S.sawtooth(d["xl"] * 10, 0.7)),
      ("chirp", lambda: S.chirp(abs(d["xl"]), 1.0, 2.0, 10.0,
                                method="logarithmic")),
      ("gausspulse", lambda: S.gausspulse(d["xl"] * 0.002, fc=500)),
      ("sweep_poly", lambda: S.sweep_poly(d["xl"], [0.05, -0.75, 2.0, 5.0])),
  ]


def signal_oracle() -> dict:
  import scipy.signal as ssig
  d = signal_data()
  out = {}
  for label, fn in _sig_calls(ssig, d):
    v = np.asarray(fn()).reshape(-1)
    out[label] = (v[sig_pick(v.size)], float(np.abs(v).max()))
  return out


def filter_data():
  rng = np.random.default_rng([P25_SEED, 500])
  return rng.standard_normal((FILT_CH, LF_N))


def filter_oracle() -> dict:
  """scipy's recurrences on the 256 channels (a worker process)."""
  import scipy.signal as ssig
  X = filter_data()
  b, a = ssig.butter(4, 0.1)
  sos = ssig.butter(8, 0.1, output="sos")
  rows = np.random.default_rng([P25_SEED, 501]).choice(FILT_CH, min(16, FILT_CH),
                                                      replace=False)
  return {"rows": rows,
          "lfilter": ssig.lfilter(b, a, X, axis=-1)[rows],
          "filtfilt": ssig.filtfilt(b, a, X, axis=-1)[rows],
          "sosfilt": ssig.sosfilt(sos, X[:, :SOS_N], axis=-1)[rows],
          "sosfiltfilt": ssig.sosfiltfilt(sos, X[:, :SOS_N], axis=-1)[rows],
          "decimate": ssig.decimate(X, 4, axis=-1)[rows]}


def submit_phase25_oracles(procs) -> dict:
  """Phase 25's scipy oracles, submitted to the worker processes before
  the build: every input is NumPy's draw from a seed, made again there."""
  return {"dist": procs.submit(dist_oracle),
          "desc": procs.submit(desc_oracle),
          "test": procs.submit(test_oracle),
          "kde": procs.submit(kde_oracle),
          "signal": procs.submit(signal_oracle),
          "filter": procs.submit(filter_oracle)}


def _err_over(got, want, rtol, atol) -> float:
  """The worst |got - want| / (atol + rtol |want|) (NaN and inf must
  agree): <= 1 passes."""
  got = np.asarray(got, dtype=np.complex128 if np.iscomplexobj(got)
                   or np.iscomplexobj(want) else np.float64)
  want = np.asarray(want, dtype=got.dtype)
  if got.shape != want.shape:
    return np.inf
  if ((np.isnan(got) != np.isnan(want)).any()
      or (np.isinf(got) != np.isinf(want)).any()
      or (np.isinf(want) & (got != want)).any()):
    return np.inf
  fin = np.isfinite(want)
  if not fin.any():
    return 0.0
  diff = np.abs(got[fin] - want[fin])
  lim = atol + rtol * np.abs(want[fin])
  return float(np.max(np.where(lim > 0, diff / np.where(lim > 0, lim, 1),
                               np.where(diff > 0, np.inf, 0.0))))


def _held25(label: str, err: float, tol: float, why: str) -> None:
  print(f"  {label}: {err:.3g} (bound {tol:.3g}: {why})")
  check(err <= tol, f"phase 25: {label} {err:.3g} > {tol:.3g}")


def _host25(e) -> np.ndarray:
  return np.asarray(sp.lazify(e).glom())


def dist_items(device, oracle) -> float:
  """Every method of the 24 device distributions at DIST_N float64 points
  on the card (the betainc bisections at DIST_SLOW_N), held to scipy on
  the first DIST_SAMPLE; float32 for norm/expon/gamma/beta; the draws of
  each against its own cdf (KS) or its mean and variance.  Returns the
  seconds of the slow cases."""
  St = sp.stats
  want = oracle_result(oracle)
  worst, slow_s = [], {}
  t0 = time.perf_counter()
  for case in DIST_CASES:
    name, scale = case[0], case[3]
    dist = getattr(St, name)
    a = _dist_args(case)
    x, q = dist_points(case, DIST_N)
    xd, qd = (torch.as_tensor(v, device=device) for v in (x, q))
    for m in (DISC_METHODS if scale is None else CONT_METHODS):
      if (name, m) in DIST_OFF_CARD:
        continue
      slow = (name, m) in DIST_SLOW
      arg = qd if m in ("ppf", "isf") else xd
      if slow:
        arg = arg[:DIST_SLOW_N]
      t_m = time.perf_counter()
      got = getattr(dist, m)(arg, *a).evaluate().data
      torch.cuda.synchronize()
      if slow:
        slow_s[f"{name}.{m}"] = time.perf_counter() - t_m
      check(got.shape == arg.shape and got.dtype == torch.float64,
            f"{name}.{m} gave {tuple(got.shape)} {got.dtype}")
      rtol, atol = DIST_TOL[m]
      worst.append((_err_over(got[:DIST_SAMPLE].cpu().numpy(),
                              want[name, m], rtol, atol), f"{name}.{m}"))
    ent = (float(_host25(dist.entropy(*a))) if name in DEVICE_ENTROPY
           else np.nan)
    if (name, "ppf") in DIST_SLOW:
      # one bisection for the three levels (median() and interval() would
      # run one each)
      levels = _host25(dist.ppf(np.array([0.5, 0.05, 0.95]), *a)).tolist()
    else:
      lo, hi = dist.interval(0.9, *a)
      levels = [float(_host25(e)) for e in (dist.median(*a), lo, hi)]
    mom = [float(_host25(e)) for e in (dist.mean(*a), dist.var(*a),
                                       dist.std(*a))] + levels + [ent]
    worst.append((_err_over(np.array(mom), want[name, "moments"],
                            *DIST_TOL["moments"]), f"{name}.moments"))
    del xd, qd
  wall = time.perf_counter() - t0
  worst.sort(reverse=True)
  print(f"  sp.stats' 24 distributions, {sum(len(DISC_METHODS if c[3] is None else CONT_METHODS) for c in DIST_CASES) - len(DIST_OFF_CARD)} "
        f"method cases at {DIST_N} float64 points "
        f"({len(DIST_SLOW) - len(DIST_OFF_CARD)} at {DIST_SLOW_N}; "
        f"{len(DIST_OFF_CARD)} on the CPU only) in {wall:.2f} s; the largest "
        "error over its bound "
        "(atol + rtol |scipy|; <= 1 passes): " + ", ".join(
            f"{n} {e:.3g}" for e, n in worst[:6]))
  print("  the betainc bisections' seconds: " + ", ".join(
      f"{n} {s:.2f}" for n, s in sorted(slow_s.items())))
  check(worst[0][0] <= 1.0, f"sp.stats.{worst[0][1]} strays from scipy "
        f"({worst[0][0]:.3g} of its bound)")
  # float32: the same points rounded to float32, against scipy's float64
  # of those float32 points
  import scipy.stats as sst
  worst32, t32 = [], time.perf_counter()
  for name in ("norm", "expon", "gamma", "beta"):
    case = next(c for c in DIST_CASES if c[0] == name)
    a = _dist_args(case)
    x, q = (v.astype(np.float32) for v in dist_points(case, DIST_N))
    dist = getattr(St, name)
    for m in ("pdf", "cdf", "ppf"):
      n = DIST_SLOW_N if name == "beta" and m == "ppf" else DIST_N
      arg = torch.as_tensor(q if m == "ppf" else x, device=device)[:n]
      got = getattr(dist, m)(arg, *a).evaluate().data
      check(got.dtype == torch.float32, f"float32 {name}.{m}: {got.dtype}")
      host = (q if m == "ppf" else x)[:DIST_SAMPLE].astype(np.float64)
      w = getattr(getattr(sst, name), m)(host, *a)
      worst32.append((_err_over(got[:DIST_SAMPLE].double().cpu().numpy(), w,
                                2e-4, 2e-5 * float(np.abs(w).max())),
                      f"{name}.{m}"))
  worst32.sort(reverse=True)
  print("  float32 pass (norm, expon, gamma, beta: pdf, cdf, ppf at "
        f"{DIST_N}, beta's ppf at {DIST_SLOW_N}) in "
        f"{time.perf_counter() - t32:.2f} s: the largest error over its bound (2e-4 relative, "
        "2e-5 of the largest value): " + ", ".join(
            f"{n} {e:.3g}" for e, n in worst32[:4]))
  check(worst32[0][0] <= 1.0, f"float32 sp.stats.{worst32[0][1]} strays")
  # the draws: each continuous one's KS distance from its own cdf (held to
  # scipy's within 1e-9 above, which moves the distance by no more), at
  # sqrt(ln(2/alpha) / 2n); the discrete ones' mean and variance
  t1 = time.perf_counter()
  ks = []
  for i, case in enumerate(DIST_CASES):
    name, scale = case[0], case[3]
    dist = getattr(St, name)
    a = _dist_args(case)
    slow = (name, "ppf") in DIST_SLOW
    n = DIST_SLOW_N if slow else RVS_N
    draws = dist.rvs(*a, size=n, random_state=P25_SEED + i).evaluate().data
    check(draws.shape == (n,) and bool(torch.isfinite(draws).all()),
          f"{name}.rvs")
    if scale is None:
      mu, var = float(_host25(dist.mean(*a))), float(_host25(dist.var(*a)))
      kurt = want[name, "kurtosis"]
      m_err = abs(float(draws.mean()) - mu) / (6 * np.sqrt(var / n))
      v_err = abs(float(draws.var()) - var) / (
          6 * var * np.sqrt((kurt + 2) / n))
      ks.append((max(m_err, v_err), f"{name} (mean, variance at 6 s.e.)"))
      continue
    F = dist.cdf(torch.sort(draws).values, *a).evaluate().data
    i_n = torch.arange(1, n + 1, dtype=F.dtype, device=F.device) / n
    d = float(torch.maximum((i_n - F).max(), (F - (i_n - 1.0 / n)).max()))
    ks.append((d / np.sqrt(np.log(2 / RVS_ALPHA) / (2 * n)), name))
  ks.sort(reverse=True)
  print(f"  rvs: {RVS_N} draws of each distribution (t, f, beta at "
        f"{DIST_SLOW_N}) in {time.perf_counter() - t1:.2f} s; the KS "
        f"distance over its bound (alpha {RVS_ALPHA}) or the moments' "
        "error over 6 standard errors, the largest: " + ", ".join(
            f"{n} {e:.3g}" for e, n in ks[:4]))
  check(ks[0][0] <= 1.0, f"sp.stats.{ks[0][1]}.rvs strays from its "
        f"distribution ({ks[0][0]:.3g} of its bound)")
  return wall


def desc_items(device, oracle) -> None:
  """The descriptive statistics on the 2^14 x 2^10 float64 matrices along
  axis 0, 1 and None, each held to scipy (results longer than DESC_SAMPLE
  on a sample) at rtol 1e-9."""
  St = sp.stats
  data = desc_data()
  dev = {k: sp.from_numpy(v) for k, v in data.items()}
  t0 = time.perf_counter()
  got = {}
  for label, fn, key, kw in DESC_CASES:
    for ax in DESC_AXES:
      res = getattr(St, fn)(dev[key], axis=ax, **kw)
      if fn == "describe":
        res = (res.nobs, res.minmax, res.mean, res.variance, res.skewness,
               res.kurtosis)
      flat = [_host25(e) if isinstance(e, sp.Expr) else np.asarray(e)
              for e in (res if isinstance(res, tuple) else (res,))
              for e in (e if isinstance(e, tuple) else (e,))]
      got[label, ax] = [np.asarray(f, np.float64).reshape(-1) for f in flat]
  torch.cuda.synchronize()
  wall = time.perf_counter() - t0
  want = oracle_result(oracle)
  worst = []
  for (label, ax), outs in got.items():
    outs = [f[desc_pick(f.size)] if f.size > DESC_SAMPLE else f
            for f in outs]
    worst.append((max(_err_over(g, w, 1e-9, 1e-12)
                      for g, w in zip(outs, want[label, ax])), f"{label}[{ax}]"))
  worst.sort(reverse=True)
  print(f"  {len(DESC_CASES)} descriptive statistics x 3 axes on "
        f"{DESC_SHAPE[0]} x {DESC_SHAPE[1]} float64 in {wall:.2f} s (host "
        "copies included); the largest error over 1e-12 + 1e-9 |scipy|: "
        + ", ".join(f"{n} {e:.3g}" for e, n in worst[:5]))
  check(worst[0][0] <= 1.0, f"sp.stats.{worst[0][1]} strays from scipy")


def test_items(oracle) -> None:
  """The hypothesis tests on 2^20-sample vectors, statistics held to scipy
  at 1e-9 and p-values at 1e-8: a t or F p-value is betainc's continued
  fraction (XLA's, as the reference runs it) at a = df / 2 of about 10^6,
  whose prefactor exp(a ln x + b ln(1 - x) - ln B(a, b)) carries ln B's
  rounding, 1.3e7 x 2^-52, about 3e-9 relative (1.2e-9 on the CPU
  beside scipy).  The KS p-values, asymptotic with Stephens' correction
  here, at 2e-2 absolute as the reference test holds them."""
  d = {k: sp.from_numpy(v) for k, v in test_data().items()}
  t0 = time.perf_counter()
  got, walls = {}, {}
  for label, fn in _test_calls(sp.stats, d):
    t_l = time.perf_counter()
    got[label] = _test_values(fn())
    walls[label] = time.perf_counter() - t_l
  wall = time.perf_counter() - t0
  want = oracle_result(oracle)
  worst = []
  for label, vals in got.items():
    if label in ("ks_2samp", "kstest"):
      worst.append((max(_err_over(vals[0], want[label][0], 1e-9, 1e-12),
                        abs(vals[1] - want[label][1]) / 2e-2), label))
      continue
    p_at = 3 if label == "linregress" else 1
    stats_ = [v for i, v in enumerate(vals) if i != p_at]
    want_ = [v for i, v in enumerate(want[label]) if i != p_at]
    worst.append((max(_err_over(stats_, want_, 1e-9, 1e-14),
                      _err_over(vals[p_at], want[label][p_at], 1e-8, 1e-14)),
                  label))
  worst.sort(reverse=True)
  print(f"  {len(got)} hypothesis tests on {TEST_N}-sample vectors in "
        f"{wall:.2f} s (the slowest: " + ", ".join(
            f"{n} {s:.2f} s" for n, s in sorted(
                walls.items(), key=lambda kv: -kv[1])[:4])
        + "); the largest error over its bound: " + ", ".join(
            f"{n} {e:.3g}" for e, n in worst[:5]))
  check(worst[0][0] <= 1.0, f"sp.stats.{worst[0][1]} strays from scipy")


def kde_item(oracle) -> None:
  ds, pts = kde_data()
  t0 = time.perf_counter()
  kde = sp.stats.gaussian_kde(sp.from_numpy(ds))
  P = sp.from_numpy(pts)
  dens = kde.evaluate(P).evaluate().data
  logd = kde.logpdf(P).evaluate().data
  torch.cuda.synchronize()
  wall = time.perf_counter() - t0
  gauss = float(kde.integrate_gaussian(np.array([0.2, 0.8, -0.9]),
                                       np.eye(3) * 0.5))
  want = oracle_result(oracle)
  err = max(_err_over(dens[:KDE_SAMPLE].cpu().numpy(), want["evaluate"],
                      1e-9, 1e-15),
            _err_over(logd[:KDE_SAMPLE].cpu().numpy(), want["logpdf"],
                      1e-9, 1e-9),
            _err_over(gauss, want["gauss"], 1e-10, 0.0))
  _held25(f"gaussian_kde of {KDE_N} points in 3-D at {KDE_POINTS} points "
          f"({KDE_POINTS * KDE_N * 8 / 1e9:.1f} GB pairwise, {wall:.2f} s), "
          "evaluate/logpdf/integrate_gaussian against scipy", err, 1.0,
          "atol + 1e-9 |scipy|")


def signal_items(device, oracle) -> None:
  """Convolution, spectra, resampling, smoothing, rank filters, Lomb-Scargle,
  czt and the waveforms, each held to scipy on a sample at 1e-9 of the
  output's largest value; stft -> istft round trip within 1e-10."""
  d = signal_data()
  dd = {k: sp.from_numpy(v) for k, v in d.items()}
  t0 = time.perf_counter()
  outs, walls = {}, {}
  for label, fn in _sig_calls(sp.signal, dd):
    t_l = time.perf_counter()
    v = sp.lazify(fn()).evaluate().data.reshape(-1)
    torch.cuda.synchronize()
    walls[label] = time.perf_counter() - t_l
    pick = torch.as_tensor(sig_pick(v.numel()), device=v.device)
    outs[label] = v[pick].cpu().numpy()
  wall = time.perf_counter() - t0
  f, tt, Z = sp.signal.stft(dd["s"], fs=1000.0, nperseg=SPEC_SEG)
  _, back = sp.signal.istft(Z, fs=1000.0, nperseg=SPEC_SEG)
  back = back.evaluate().data
  trip = float((back[:SPEC_N] - dd["s"].evaluate().data).abs().max())
  want = oracle_result(oracle)
  worst = []
  for label, got in outs.items():
    w, scale = want[label]
    worst.append((_err_over(got, w, 0.0, 1e-9 * scale), label))
  worst.sort(reverse=True)
  print(f"  {len(outs)} signal items in {wall:.2f} s; the slowest: "
        + ", ".join(f"{n} {s:.2f} s" for n, s in sorted(
            walls.items(), key=lambda kv: -kv[1])[:4]))
  print("  the largest error over 1e-9 of the output's largest value: "
        + ", ".join(f"{n} {e:.3g}" for e, n in worst[:5]))
  check(worst[0][0] <= 1.0, f"sp.signal.{worst[0][1]} strays from scipy")
  _held25(f"stft -> istft of {SPEC_N} samples (nperseg {SPEC_SEG})", trip,
          1e-10 * float(np.abs(d["s"]).max()), "1e-10 of max |x|")


def filter_items(device, card: str, oracle) -> None:
  """lfilter and filtfilt (butter 4, 0.1) over 256 channels of 2^14
  samples, sosfilt/sosfiltfilt (butter 8 as sections) of 2^12, decimate
  (q = 4, iir) of 2^14, at the reference test's bounds against scipy; the
  host and device us a sample of one lfilter pass."""
  import scipy.signal as ssig
  S = sp.signal
  X = torch.as_tensor(filter_data(), device=device)
  b, a = ssig.butter(4, 0.1)
  sos = ssig.butter(8, 0.1, output="sos")
  runs = {"lfilter": lambda: S.lfilter(b, a, X, axis=-1),
          "filtfilt": lambda: S.filtfilt(b, a, X, axis=-1),
          "sosfilt": lambda: S.sosfilt(sos, X[:, :SOS_N], axis=-1),
          "sosfiltfilt": lambda: S.sosfiltfilt(sos, X[:, :SOS_N], axis=-1),
          "decimate": lambda: S.decimate(X, 4, axis=-1)}
  bounds = {"lfilter": 1e-10, "filtfilt": 1e-9, "sosfilt": 1e-10,
            "sosfiltfilt": 1e-7, "decimate": 1e-8}
  got, walls = {}, {}
  for label, fn in runs.items():
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got[label] = fn().evaluate().data
    torch.cuda.synchronize()
    walls[label] = time.perf_counter() - t0
  want = oracle_result(oracle)
  rows = torch.as_tensor(want["rows"], device=device)
  for label, bnd in bounds.items():
    err = float(np.abs(got[label][rows].cpu().numpy() - want[label]).max())
    _held25(f"{label} of {FILT_CH} channels ({walls[label]:.2f} s)", err,
            bnd, "the reference test's bound")
  # one lfilter pass a sample: the synced walls of LF_N and LF_PROF[1]
  # samples differenced (the set-up taken out); the device-busy time under
  # torch.profiler of LF_PROF's two runs differenced (a profile of 5e4
  # launches takes the profiler a minute to fold)
  def lfilter_pass(n):
    return lambda: S.lfilter(b, a, X[:, :n], axis=-1).evaluate()
  walls = []
  for n in (LF_N, LF_PROF[1]):
    torch.cuda.synchronize()
    with Timer() as t_wall:
      lfilter_pass(n)()
      torch.cuda.synchronize()
    walls.append(t_wall.elapsed)
  devs = [device_share(lfilter_pass(n))[1] for n in LF_PROF]
  host_us = (walls[0] - walls[1]) * 1e6 / (LF_N - LF_PROF[1])
  dev = ("not measured" if None in devs else
         f"{(devs[0] - devs[1]) * 1e3 / (LF_PROF[0] - LF_PROF[1]):.3f} us")
  print(f"  lfilter's loop over {FILT_CH} channels: host {host_us:.3f} us a "
        f"sample, device {dev} a sample (three launches a sample; walls of "
        f"{LF_N} and {LF_PROF[1]} samples, profiles of {LF_PROF[0]} and "
        f"{LF_PROF[1]}, differenced) ({card})")


def oscillator_item() -> None:
  """oscillator.run() on the card: the recovered frequency within one
  Welch bin (fs / 512) of the expected one."""
  from spartan_tpu_torch.examples import oscillator
  t0 = time.perf_counter()
  got, want = oscillator.run()
  wall = time.perf_counter() - t0
  bin_hz = (2048 - 1) / 40.0 / 512
  _held25(f"oscillator.run() ({wall:.2f} s): recovered {got:.12g} Hz, "
          f"expected {want:.12g} Hz; |difference|", abs(got - want), bin_hz,
          "one Welch bin, fs / 512")


def phase_stats_signal(device, card: str, oracles: dict) -> None:
  """Phase 25: sp.stats and sp.signal at full width, and the oscillator."""
  from spartan_tpu_torch.expr import fio
  t0 = time.perf_counter()
  runs = fio.counts["host_runs"]
  ORACLE_WAIT[0] = 0.0

  def since(what: str) -> None:
    print(f"  [{time.perf_counter() - t0:.2f} s into phase 25: {what}]")

  dist_items(device, oracles["dist"])
  since("the distributions")
  desc_items(device, oracles["desc"])
  test_items(oracles["test"])
  kde_item(oracles["kde"])
  since("descriptive statistics, tests, gaussian_kde")
  gc.collect()
  torch.cuda.empty_cache()
  signal_items(device, oracles["signal"])
  filter_items(device, card, oracles["filter"])
  since("the signal items and the recurrences")
  oscillator_item()
  # one host name of each module through its counted boundary
  before = fio.counts["host_runs"]
  v = sp.from_numpy(np.linspace(-2.0, 2.0, 64))
  import scipy.stats as sst
  check(abs(sp.stats.shapiro(v).statistic
            - sst.shapiro(np.linspace(-2.0, 2.0, 64)).statistic) < 1e-12
        and float(np.asarray(sp.stats.t.entropy(5.0)))
        == float(sst.t.entropy(5.0))
        and list(sp.signal.correlation_lags(5, 3)) == list(range(-2, 5)),
        "the host boundaries")
  check(fio.counts["host_runs"] - before == 3,
        f"the host boundaries counted {fio.counts['host_runs'] - before}")
  host_runs = fio.counts["host_runs"] - runs
  print(f"  phase 25 host_runs {host_runs}; "
        f"{time.perf_counter() - t0:.2f} s, {ORACLE_WAIT[0]:.2f} s of it "
        "waiting for the oracle processes")


# -- phase 26: sp.ndimage and sp.spatial --------------------------------------

P26_SEED = 26
IMG_SIDE = 8192  # the filters' and the morphology's images: 268 MB float32
IMG_ROWS = 64  # rows of each 8192^2 filter held to scipy (the 5 first and last)
VOL_SIDE = 256  # the 3-D Gaussian's volume
VOL_SAMPLE = 1 << 16
BLOB_SIGMA, BLOB_LEVEL = 4.0, 1.0  # smoothed noise above 1 standard deviation
CORR_SIDE = 16384  # the 3x3 correlate timed at K4's shape
INTERP_SIDE, COORD_N = 4096, 1 << 22
CDIST_N, CDIST_D = 8192, 64
KD_N, KD_Q, KD_K = 1 << 18, 8192, 8  # 8 GB of float32 tile in 1 GB chunks
ROT_N, ROT_SAMPLE = 1 << 20, 1 << 16
U32 = 2.0 ** -24  # float32's unit roundoff
# K4's row of PERF.md §6 at 16384^2 float32, the 3x3 correlate's shape: its
# ms and cuDNN's (NVIDIA H100 80GB HBM3, 700 W)
K4_MS, K4_CUDNN_MS = 1.0029, 28.6450


def _rng26(k: int):
  return np.random.default_rng([P26_SEED, k])


def image26():
  return _rng26(1).standard_normal((IMG_SIDE, IMG_SIDE), dtype=np.float32)


def weights26():
  r = _rng26(2)
  return r.standard_normal((3, 3)), r.standard_normal((5, 5))


def rows26(n: int) -> np.ndarray:
  inner = _rng26(4).choice(np.arange(5, n - 5), IMG_ROWS - 10, replace=False)
  return np.sort(np.concatenate([np.arange(5), n - 5 + np.arange(5), inner]))


# (label, the call on a module with scipy.ndimage's API, float32 passes as
# (taps, sum |w|) for the bound; None: exact, the values are the input's)
W3, W5 = weights26()
FILTERS26 = [
    ("gaussian_filter sigma 3", lambda M, x: M.gaussian_filter(x, 3.0),
     [(25, 1.0), (25, 1.0)]),
    ("uniform_filter 5", lambda M, x: M.uniform_filter(x, 5),
     [(5, 1.0), (5, 1.0)]),
    ("median_filter 3", lambda M, x: M.median_filter(x, 3), None),
    ("sobel axis 0", lambda M, x: M.sobel(x, 0), [(3, 2.0), (3, 4.0)]),
    ("sobel axis 1", lambda M, x: M.sobel(x, 1), [(3, 2.0), (3, 4.0)]),
    ("correlate 3x3", lambda M, x: M.correlate(x, W3),
     [(9, float(np.abs(W3).sum()))]),
    ("correlate 5x5", lambda M, x: M.correlate(x, W5),
     [(25, float(np.abs(W5).sum()))]),
]


def conv_atol(passes, x_max: float) -> float:
  """A float32 filter's bound against scipy's float32 result: each pass
  sums ``taps`` rounded products (taps + 3 roundings of the window's
  absolute sum, with the weights' own and the output's), an earlier pass's
  error carried through the later weights; times 4, since cuDNN may take a
  Winograd or FFT algorithm whose rounding is a few times the direct
  sum's."""
  err, scale = 0.0, x_max
  for taps, wsum in passes:
    scale *= wsum
    err = err * wsum + (taps + 3) * U32 * scale
  return 4.0 * err


def blobs26():
  """Thresholded smoothed noise: blobs of many sizes (scipy, float64)."""
  import scipy.ndimage as ndi
  noise = _rng26(11).standard_normal((IMG_SIDE, IMG_SIDE))
  smooth = ndi.gaussian_filter(noise, BLOB_SIGMA)
  return smooth > BLOB_LEVEL * smooth.std()


def weights_image26():
  return _rng26(5).random((IMG_SIDE, IMG_SIDE), dtype=np.float32)


def interp26():
  return _rng26(6).standard_normal((INTERP_SIDE, INTERP_SIDE),
                                   dtype=np.float32)


def coords26():
  return _rng26(7).uniform(-1.0, INTERP_SIDE, (2, COORD_N))


def cdist26():
  r = _rng26(8)
  return (r.standard_normal((CDIST_N, CDIST_D), dtype=np.float32),
          r.standard_normal((CDIST_N, CDIST_D), dtype=np.float32))


def kd26():
  r = _rng26(9)
  return (r.random((KD_N, 3), dtype=np.float32),
          r.random((KD_Q, 3), dtype=np.float32))


def quats26():
  r = _rng26(10)
  return r.standard_normal((ROT_N, 4)), r.standard_normal((ROT_N, 3))


def filter_oracle26() -> dict:
  """scipy.ndimage's float32 filters of image26 at rows26 (a worker)."""
  import scipy.ndimage as ndi
  x = image26()
  rows = rows26(IMG_SIDE)
  out = {label: fn(ndi, x)[rows] for label, fn, _ in FILTERS26}
  vol = _rng26(3).standard_normal((VOL_SIDE,) * 3, dtype=np.float32)
  pick = _rng26(12).choice(vol.size, VOL_SAMPLE, replace=False)
  out["volume"] = ndi.gaussian_filter(vol, 2.0).reshape(-1)[pick]
  out["x_max"] = float(np.abs(x).max())
  out["vol_max"] = float(np.abs(vol).max())
  return out


def morph_oracle26() -> dict:
  """The blobs, scipy's opening, filled holes and labels of them, and the
  measurements of weights_image26 over every label (a worker; the binary
  images packed to bits)."""
  import scipy.ndimage as ndi
  B = blobs26()
  lab, n = ndi.label(B)
  xw = weights_image26()
  idx = np.arange(1, n + 1)
  return {"blobs": np.packbits(B), "opening": np.packbits(
      ndi.binary_opening(B)), "fill": np.packbits(ndi.binary_fill_holes(B)),
          "labels": lab, "n": n, "sum": ndi.sum_labels(xw, lab, idx),
          "mean": ndi.mean(xw, lab, idx),
          "max_pos": np.asarray(ndi.maximum_position(xw, lab, idx)),
          "max_ties": ndi.sum_labels(xw == np.r_[0, ndi.maximum(
              xw, lab, idx)].astype(np.float32)[lab], lab, idx),
          "com": np.asarray(ndi.center_of_mass(xw, lab, idx)),
          "total": float(xw.sum(dtype=np.float64))}


def interp_oracle26() -> dict:
  import scipy.ndimage as ndi
  img = interp26()
  zoomed = ndi.zoom(img, 1.5, order=1)
  return {"zoom": zoomed[rows26(zoomed.shape[0])],
          "rotate": ndi.rotate(img, 30.0, reshape=False, order=1)[
              rows26(INTERP_SIDE)],
          "coords": ndi.map_coordinates(img, coords26(), order=1),
          "x_max": float(np.abs(img).max())}


def spatial_oracle26() -> dict:
  """scipy.spatial's distances at sampled rows, cKDTree's 9 nearest and
  Rotation's conversions at sampled rotations (a worker, float64)."""
  import scipy.spatial as ssp
  import scipy.spatial.distance as ssd
  from scipy.spatial.transform import Rotation as SR
  a, b = (v.astype(np.float64) for v in cdist26())
  rows = rows26(CDIST_N)
  pts, q = (v.astype(np.float64) for v in kd26())
  d9, i9 = ssp.cKDTree(pts).query(q, k=KD_K + 1)
  quats, vecs = quats26()
  pick = _rng26(13).choice(ROT_N, ROT_SAMPLE, replace=False)
  R = SR.from_quat(quats)
  return {"euclidean": ssd.cdist(a[rows], b),
          "cityblock": ssd.cdist(a[rows], b, "cityblock"),
          "a_sq": (a[rows] ** 2).sum(1), "b_sq": (b ** 2).sum(1),
          "d9": d9, "i9": i9, "matrix": R[pick].as_matrix(),
          "euler": R[pick].as_euler("zyx"),
          "apply": R[pick].apply(vecs[pick]),
          "mean": R.mean().as_matrix()}


def submit_phase26_oracles(procs) -> dict:
  """Phase 26's scipy oracles, submitted after phase 25's to the worker
  processes that start before the build."""
  return {"filters": procs.submit(filter_oracle26),
          "morph": procs.submit(morph_oracle26),
          "interp": procs.submit(interp_oracle26),
          "spatial": procs.submit(spatial_oracle26)}


def _held26(label: str, err: float, tol: float, why: str, secs: float):
  print(f"  {label}: {secs:.2f} s; {err:.3g} (bound {tol:.3g}: {why})")
  check(err <= tol, f"phase 26: {label} {err:.3g} > {tol:.3g}")


def _wrapped(a: np.ndarray) -> np.ndarray:
  """An angle difference folded into [-pi, pi]."""
  return np.abs((a + np.pi) % (2 * np.pi) - np.pi)


def image_filter_items(device, card: str, oracle) -> None:
  """The filters on one 8192^2 float32 image and the 3-D Gaussian on a
  256^3 volume, held to scipy's float32 results at sampled rows; the 3x3
  correlate timed at 16384^2 beside K4."""
  N = sp.ndimage
  want = oracle_result(oracle)
  X = sp.from_numpy(image26())
  rows = torch.as_tensor(rows26(IMG_SIDE), device=device)
  for label, fn, passes in FILTERS26:
    t0 = time.perf_counter()
    out = fn(N, X).evaluate().data
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    check(out.dtype == torch.float32 and tuple(out.shape) == (IMG_SIDE,) * 2,
          f"{label}: {out.dtype} {tuple(out.shape)}")
    got = out[rows].cpu().numpy()
    err = float(np.abs(got.astype(np.float64) - want[label]).max())
    if passes is None:
      _held26(label, err, 0.0, "exact: an element of its window", secs)
    else:
      tol = conv_atol(passes, want["x_max"])
      _held26(label, err, tol, "float32 sums, conv_atol", secs)
    del out
  del X
  vol = sp.from_numpy(_rng26(3).standard_normal((VOL_SIDE,) * 3,
                                                dtype=np.float32))
  t0 = time.perf_counter()
  out = N.gaussian_filter(vol, 2.0).evaluate().data
  torch.cuda.synchronize()
  secs = time.perf_counter() - t0
  pick = torch.as_tensor(_rng26(12).choice(VOL_SIDE ** 3, VOL_SAMPLE,
                                           replace=False), device=device)
  got = out.reshape(-1)[pick].cpu().numpy().astype(np.float64)
  _held26(f"gaussian_filter sigma 2 on {VOL_SIDE}^3",
          float(np.abs(got - want["volume"]).max()),
          conv_atol([(17, 1.0)] * 3, want["vol_max"]),
          "float32 sums, conv_atol", secs)
  del vol, out
  # the 3x3 correlate at K4's shape: the port's map (one pad, then cuDNN's
  # conv2d) and cuDNN's conv2d alone on the padded grid
  from spartan_tpu_torch import ndimage as nd
  x16 = torch.randn((CORR_SIDE, CORR_SIDE), device=device,
                    generator=torch.Generator(device=device).manual_seed(
                        P26_SEED))
  kern = nd._corr_kernel(W3, "reflect", 0.0, (0, 0))
  xp = nd._pad(x16, [(1, 1), (1, 1)], "reflect", 0.0)
  w = torch.as_tensor(W3, dtype=torch.float32, device=device)
  ms = time_in_turns({"ndimage.correlate": lambda: kern(x16),
                      "conv2d": lambda: F.conv2d(xp[None, None],
                                                 w[None, None])},
                     reps=3)
  b_ms, _ = bound(2 * CORR_SIDE ** 2 * 4, 0.0)
  print(f"  ndimage.correlate 3x3 at {CORR_SIDE}^2 float32 ({card}): "
        f"{ms['ndimage.correlate']:.4f} ms (the reflect pad and cuDNN's "
        f"conv2d), conv2d alone {ms['conv2d']:.4f} ms; bound {b_ms:.4f} ms "
        f"(bytes); K4 {K4_MS:.4f} ms and cuDNN {K4_CUDNN_MS:.4f} ms at this "
        "shape in PERF.md §6")
  del x16, xp


def morph_items(device, oracle) -> int:
  """Opening, filled holes and labels of the 8192^2 blobs, exactly
  scipy's; the measurements over every label at float32 bounds; the
  unlabelled sum through K1.  Returns K1's launches."""
  from spartan_tpu_torch import ndimage as nd
  N = sp.ndimage
  want = oracle_result(oracle)
  nbits = IMG_SIDE * IMG_SIDE

  def unpack(bits):
    return np.unpackbits(bits)[:nbits].reshape(IMG_SIDE, IMG_SIDE) \
        .astype(bool)
  B = sp.from_numpy(unpack(want["blobs"]))
  t0 = time.perf_counter()
  opened = N.binary_opening(B).glom()
  _held26("binary_opening", float(np.count_nonzero(
      opened != unpack(want["opening"]))), 0.0, "exact, pixels differing",
          time.perf_counter() - t0)
  for name, run, key in (("binary_fill_holes", lambda: N.binary_fill_holes(
      B).glom(), "flood_rounds"), ("label", lambda: N.label(B),
                                   "label_rounds")):
    before = dict(nd.counts)
    t0 = time.perf_counter()
    got = run()
    secs = time.perf_counter() - t0
    rounds = nd.counts[key] - before[key]
    reads = nd.counts["reads"] - before["reads"]
    if name == "label":
      labels, n = got
      diff = float(np.count_nonzero(labels != want["labels"])) + abs(
          n - want["n"])
    else:
      diff = float(np.count_nonzero(got != unpack(want["fill"])))
    _held26(f"{name} ({rounds} rounds, {reads} host reads)", diff, 0.0,
            "exact, pixels differing", secs)
  print(f"  {n} labels of the {IMG_SIDE}^2 blobs")
  L = sp.from_numpy(labels)
  XW = sp.from_numpy(weights_image26())
  idx = np.arange(1, n + 1)
  for name, fn, key in (
      ("sum_labels", lambda: N.sum_labels(XW, L, idx), "sum"),
      ("mean", lambda: N.mean(XW, L, idx), "mean"),
      ("maximum_position", lambda: np.asarray(N.maximum_position(XW, L, idx)),
       "max_pos"),
      ("center_of_mass", lambda: np.asarray(N.center_of_mass(XW, L, idx)),
       "com")):
    t0 = time.perf_counter()
    got = fn()
    secs = time.perf_counter() - t0
    if key == "max_pos":
      one = want["max_ties"] == 1
      _held26(f"{name} over the {int(one.sum())} labels of one maximal "
              "pixel", float(np.count_nonzero(got[one] != want[key][one])),
              0.0, "exact", secs)
    else:
      _held26(f"{name} over {n} labels", _err_over(got, want[key], 2 * U32,
                                                   0.0), 1.0,
              "float64 segment sums rounded once to float32: 2^-23 "
              "relative", secs)
  launches = K.counts["launches"]
  t0 = time.perf_counter()
  total = N.sum_labels(XW)
  launches = K.counts["launches"] - launches
  check(launches >= 1, "sum_labels of a float32 image did not launch K1")
  _held26(f"sum_labels without labels (K1, {launches} launch)",
          rel_err(total, want["total"]), 1e-5,
          "K1's float32 accumulator bound (phase 2)",
          time.perf_counter() - t0)
  return launches


def interp_items(device, oracle) -> None:
  """zoom 1.5, rotate 30 degrees and map_coordinates of 2^22 points, order
  1, on a 4096^2 float32 image, against scipy's float32 results: both
  blend in float64 and round once, so they agree to an ulp at the image's
  scale."""
  N = sp.ndimage
  want = oracle_result(oracle)
  img = sp.from_numpy(interp26())
  tol = 2 * U32 * want["x_max"]
  for label, fn, key in (
      ("zoom 1.5", lambda: N.zoom(img, 1.5, order=1), "zoom"),
      ("rotate 30, reshape=False",
       lambda: N.rotate(img, 30.0, reshape=False, order=1), "rotate"),
      (f"map_coordinates of {COORD_N} points",
       lambda: N.map_coordinates(img, coords26(), order=1), "coords")):
    t0 = time.perf_counter()
    out = fn().evaluate().data
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    check(out.dtype == torch.float32, f"{label}: {out.dtype}")
    if key == "coords":
      got = out.cpu().numpy()
    else:
      rows = torch.as_tensor(rows26(out.shape[0]), device=out.device)
      got = out[rows].cpu().numpy()
    _held26(label, float(np.abs(got.astype(np.float64)
                                - want[key].astype(np.float64)).max()),
            tol, "one float32 rounding each of a float64 blend", secs)
    del out


def spatial_items(device, oracle) -> None:
  """cdist of 8192 x 8192 points in 64 dimensions (euclidean by the matmul
  form, cityblock by the chunked broadcast), a KDTree's 8 nearest of 8192
  queries among 2^18 points (8 GB of tile in 1 GB chunks) and Rotation
  over 2^20 quaternions, against scipy."""
  from spartan_tpu_torch import spatial as sp_mod
  from spartan_tpu_torch import spatial_distance as dist_mod
  want = oracle_result(oracle)
  a, b = (sp.from_numpy(v) for v in cdist26())
  rows = torch.as_tensor(rows26(CDIST_N), device=device)
  for m in ("euclidean", "cityblock"):
    chunks = dist_mod.counts["chunks"]
    t0 = time.perf_counter()
    out = sp.spatial.distance.cdist(a, b, m).evaluate().data
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    got = out[rows].double().cpu().numpy()
    if m == "euclidean":
      # |a|^2 + |b|^2 - 2ab in float32: each term within 64 roundings of
      # its size, so d^2 within 64 u (|a|^2 + |b|^2) + 2 x 64 u |a||b|
      s = want["a_sq"][:, None] + want["b_sq"][None, :]
      err = float((np.abs(got ** 2 - want[m] ** 2) / (
          3 * CDIST_D * U32 * s)).max())
      _held26(f"cdist {m} {CDIST_N}^2 x {CDIST_D}", err, 1.0,
              "d^2 within 3 x 64 u (|a|^2 + |b|^2), the matmul form", secs)
    else:
      _held26(f"cdist {m} {CDIST_N}^2 x {CDIST_D} "
              f"({dist_mod.counts['chunks'] - chunks} chunks)",
              _err_over(got, want[m], CDIST_D * U32, 0.0), 1.0,
              "64 float32 roundings of the sum", secs)
    del out
  del a, b
  pts, q = kd26()
  tree = sp.spatial.KDTree(sp.from_numpy(pts))
  tiles = sp_mod.counts["tile_chunks"]
  t0 = time.perf_counter()
  d, i = tree.query(sp.from_numpy(q), k=KD_K)
  got_d, got_i = (v.glom() for v in sp.TupleExpr([d, i]).evaluate())
  secs = time.perf_counter() - t0
  d9 = want["d9"]
  # the tile's |q|^2 + |x|^2 - 2 q.x in float32 (3 terms a dot) is within
  # e2 = 40 u (|q|^2 + 3) of d^2, points in the unit cube: it picks the 8
  # (their distances then taken again as |q - x|) up to swaps within e2
  e2 = 40 * U32 * ((q.astype(np.float64) ** 2).sum(1) + 3.0)[:, None]
  d2_err = float((np.abs(got_d.astype(np.float64) ** 2 - d9[:, :KD_K] ** 2)
                  / (2 * e2 + 8 * U32 * d9[:, :KD_K] ** 2)).max())
  clear = (np.diff(d9 ** 2, axis=1) > 2 * e2).all(1)
  idx_diff = int(np.count_nonzero(got_i[clear] != want["i9"][clear, :KD_K]))
  _held26(f"KDTree({KD_N} points).query(k={KD_K}) of {KD_Q} queries "
          f"({sp_mod.counts['tile_chunks'] - tiles} tile chunks): squared "
          "distances", d2_err, 1.0, "2 e2 + 8 u d^2", secs)
  _held26(f"  the indices of the {int(clear.sum())} queries whose 9 "
          "nearest are more than 2 e2 apart", float(idx_diff), 0.0, "exact",
          0.0)
  del tree, d, i
  quats, vecs = quats26()
  pick = torch.as_tensor(_rng26(13).choice(ROT_N, ROT_SAMPLE, replace=False),
                         device=device)
  R = sp.spatial.transform.Rotation.from_quat(sp.from_numpy(quats))
  V = sp.from_numpy(vecs)
  for label, fn, key, tol in (
      ("as_matrix", lambda: R.as_matrix(), "matrix", 1e-14),
      ("apply", lambda: R.apply(V), "apply", 1e-13),
      ("as_euler zyx", lambda: R.as_euler("zyx"), "euler", 1e-10)):
    t0 = time.perf_counter()
    out = fn().evaluate().data
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    got = out[pick].cpu().numpy()
    diff = _wrapped(got - want[key]) if key == "euler" else np.abs(
        got - want[key])
    _held26(f"Rotation of {ROT_N} quaternions: {label}", float(diff.max()),
            tol, "float64", secs)
  t0 = time.perf_counter()
  mean = R.mean().as_matrix().glom()
  _held26(f"Rotation of {ROT_N} quaternions: mean",
          float(np.abs(mean - want["mean"]).max()), 1e-10,
          "float64, the top eigenvector of the 4 x 4 moment",
          time.perf_counter() - t0)


def phase_ndimage_spatial(device, card: str, oracles: dict) -> dict:
  """Phase 26: sp.ndimage and sp.spatial at the sizes their users run."""
  t0 = time.perf_counter()
  ORACLE_WAIT[0] = 0.0
  torch.cuda.reset_peak_memory_stats()

  def since(what: str) -> None:
    print(f"  [{time.perf_counter() - t0:.2f} s into phase 26: {what}]")
  image_filter_items(device, card, oracles["filters"])
  since("the filters")
  gc.collect()
  torch.cuda.empty_cache()
  k1 = morph_items(device, oracles["morph"])
  since("morphology, label and the measurements")
  gc.collect()
  torch.cuda.empty_cache()
  interp_items(device, oracles["interp"])
  since("interpolation")
  spatial_items(device, oracles["spatial"])
  print(f"  phase 26 peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; "
        f"{time.perf_counter() - t0:.2f} s, {ORACLE_WAIT[0]:.2f} s of it "
        "waiting for the oracle processes")
  return {"k1": k1}


def main() -> None:
  # phase 0: identify the card; no card, no result
  if not torch.cuda.is_available():
    raise RuntimeError("torch.cuda.is_available() is False: this smoke run "
                       "needs an NVIDIA GPU")
  card = card_line()
  print(card)
  import scipy
  print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, scipy {scipy.__version__}")
  sp.initialize([f"--device={DEVICE}"])
  device = sp.get_mesh().device
  t_start = time.perf_counter()
  t_phase = [t_start]

  def done(phase: int) -> float:
    now = time.perf_counter()
    wall = now - t_phase[0]
    print(f"  phase {phase} wall {wall:.2f} s")
    t_phase[0] = now
    return wall

  # scipy's float64 oracles of phase 6's 2^22 PageRank and of phase 22 run
  # in worker processes from here on, beside the build
  procs = oracle_processes()
  pagerank_oracle = procs.submit(urand_pagerank_oracle, PR_BIG_N, 1)
  oracles23 = submit_phase23_oracles(procs)
  oracles22 = submit_phase22_oracles(procs)
  oracles24 = submit_phase24_oracles(procs)
  oracles25 = submit_phase25_oracles(procs)
  oracles26 = submit_phase26_oracles(procs)

  print("phase 1: build the kernels, one nvcc per source, in parallel")
  build.load_all(KERNELS)
  for name in KERNELS:
    print(f"  built {build.library_path(name).name} in "
          f"{build.build_seconds.get(name, 0.0):.2f} s")
    for line in build.build_log(name).splitlines():
      if "registers" in line or "spill" in line:
        print("  ptxas:", line.strip())
  done(1)

  print("phase 2: K1 against its plain version on the card")
  k1 = phase_kernel_vs_plain(device, card)
  done(2)

  rng = np.random.default_rng(0)
  K.reset_counts()  # count the main path's launches only
  print("phase 3: fused map+reduce and dot through the port's entry points")
  phase_map_reduce_and_dot(rng)
  done(3)
  print("phase 4: linear-regression training")
  phase_training(rng)
  k1["launches"] = K.counts["launches"]
  check(k1["launches"] >= 1, "the main path never launched K1")
  done(4)

  big, small, cfg5 = (urand_graph(PR_BIG_N, 1), urand_graph(PR_SMALL_N, 2),
                      config5_graph())
  print("phase 5: K3a and K3b against their plain versions on the card")
  k3 = phase_spmv_kernels(device, card, big, small)
  done(5)

  KS.reset_counts()  # count the PageRank path's launches only
  print("phase 6: PageRank through pagerank.fit_sparse at full width")
  graphs = phase_pagerank(big, small, cfg5, pagerank_oracle)  # for 14
  k3["spmv_ell"]["launches"] = KS.counts["ell_launches"]
  k3["spmv_csr"]["launches"] = KS.counts["csr_launches"]
  done(6)

  print("phase 7: K5a against its plain version on the card; ratings of "
        "MovieLens 20M's shape")
  with Timer() as t_draw:
    R = movielens_shaped(device)
  print(f"  drew the ratings in {t_draw.elapsed:.2f} s")
  S = ingest_ratings(R)
  k5 = phase_spmm_kernel(device, card, S)
  done(7)

  K5.reset_counts()  # count the ALS path's launches only
  print("phase 8: ALS through als.fit at full width")
  k5["launches"], als_ref = phase_als(R, S)  # factors held for phase 14
  done(8)
  # the ratings' device arrays (ELL 25 GB, CSR, transposes) go with S; R
  # (host scipy) stays for phase 12.  Read what is left before and after a
  # collection of cyclic garbage, so that a cycle holding them shows.
  held = torch.cuda.memory_allocated()
  del S
  dropped = torch.cuda.memory_allocated()
  gc.collect()
  torch.cuda.empty_cache()
  print(f"  device memory allocated: {held / 1e9:.2f} GB with the ratings, "
        f"{dropped / 1e9:.2f} GB once they are dropped, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB after gc.collect()")

  K6.reset_counts()  # K4's launches: phase 9's checks (no package caller)
  print("phase 9: K4 and K6a against their plain versions on the card")
  k4, k6a = phase_stencil_kernels(device, card)
  done(9)
  print("phase 10: heat and Jacobi-Poisson sweeps at 16384^2, heat.simulate, "
        "convnet")
  k6a["launches"], heat_ref = phase_stencil_path(device, card)
  done(10)

  print(f"  device memory allocated before phase 11: "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
  print("phase 11: K2 against its plain version; matmul at 32768^2 float32 "
        "and 8192^2 bfloat16")
  worst_k2 = phase_matmul_kernel(device)
  K2.reset_counts()  # count the entry point's launches at full size only
  k2 = phase_matmul_path(device, card)
  k2_row = dict(k2[(CFG2_N, torch.float32)],
                max_abs_err=max(worst_k2, *(r["max_abs_err"]
                                            for r in k2.values())),
                launches=K2.counts["launches"])
  check(k2_row["launches"] >= 2 and K2.counts["plain_runs"] == 0,
        f"the matmul path did not launch K2 ({K2.counts})")
  done(11)

  print("phase 12: K3c against its plain version, timed on the urand 2^22 "
        "graph and ML-20M's R.T (held since phases 5 and 7); "
        "make_spmv_windowed on both packs")
  k3c = phase_spmv_chunked(device, card, big, R)
  KS.reset_counts()  # count the windowed entry point's launches only
  k3c["launches"] = phase_windowed_entry_point(device, big, R)
  check(k3c["launches"] >= 2 and KS.counts["chunked_windowed_launches"] >= 1
        and KS.counts["chunked_plain_runs"] == 0,
        f"make_spmv_windowed did not launch K3c in both forms ({KS.counts})")
  done(12)

  print("phase 13: k-means (config 4) and logistic regression (config 3)")
  phase_kmeans_logreg(device, card)
  done(13)

  print("phase 14: the sharded kernels on meshes of 2, 4 and 8 shards of the "
        "card: PageRank, ALS and stencil sweeps against phases 6, 8 and 10")
  sharded = phase_sharded(device, card, graphs, R, als_ref, heat_ref)
  urand, urand_ranks = graphs["urand 2^22"]  # held for phase 22
  del big, small, cfg5, R, graphs, als_ref, heat_ref
  done(14)
  gc.collect()
  torch.cuda.empty_cache()

  print("phase 15: the expression surface on the card at 16384^2 float32: "
        "**, //, % through K1, the new reductions, slices, gathers, a "
        "boolean mask, .at with duplicates, nanmean")
  surface_launches = phase_expression_surface(device, card)
  check(surface_launches >= 3, "phase 15 did not launch K1 three times")
  k1["launches"] += surface_launches
  done(15)

  print("phase 16: the elementwise, constructor and selection builtins at "
        "16384^2 float32: K1 on the new ufuncs, K2 with a tanh epilogue, "
        "eye/linspace/meshgrid/zeros_like, nonzero/compress/choose/resize/"
        "unique/isin/bincount, map_with_location")
  HOST_SPANS.clear()
  builtin_k1, builtin_k2 = phase_builtins(device, card)
  check(builtin_k1 >= 7, "phase 16 did not launch K1 seven times")
  k1["launches"] += builtin_k1
  k2_row["launches"] += builtin_k2
  print_host_spans(16, done(16))

  print("phase 17: the linear-algebra, statistics, polynomial, histogram and "
        "shape builtins at 16384^2 float32: K1 through sp.norm, einsum, "
        "tensordot, vdot, kron, cov, corrcoef, concatenate/stack/tile/roll/"
        "pad/rot90/flip/array_split, histogram, interp, convolve, diff, "
        "gradient, take_along_axis, packbits/unpackbits")
  slice_k1 = phase_slice(device, card)
  check(slice_k1 >= 3, "phase 17 did not launch K1 three times")
  k1["launches"] += slice_k1
  print_host_spans(17, done(17))
  print("phase 18: the sorts, searches, order statistics and prefix scans at "
        "16384^2 float32: sort/argsort along each axis and of 2^28 "
        "elements, stable argsorts of 2^26 tied keys, cumsum/cumprod/cummax/"
        "cummin, median/percentile/nanmedian, searchsorted/digitize, "
        "permutation, a logaddexp scan_fn")
  phase_sorts(device, card)
  print_host_spans(18, done(18))
  print("phase 19: while_loop, scan_iters and cond; the Krylov solvers of "
        "sp.sparse.linalg in float32 with their matvecs on K3a/K3b: cg on "
        "a 2048^2 heat step (and on 8 shards through K3d), bicgstab and "
        "gmres(20) on convection-diffusion, cg and minres at 32768, lsqr "
        "and lsmr on a 2^22 x 2^20 system")
  solver_launches = phase_solvers(device, card)
  k3["spmv_ell"]["launches"] += solver_launches["ell"]
  k3["spmv_csr"]["launches"] += solver_launches["csr"]
  sharded["sharded_windowed_spmv"]["launches"] += solver_launches[
      "sharded_csr"]
  done(19)
  print("phase 20: sp.sparse's builders (the 5-point Laplacian of a 2048^2 "
        "and a 128 x 256 grid by kronsum of diags, Lanczos on them through "
        "K3b and K3a, sparse.random at 2^22 x 2^22 and its norm through "
        "K1), sp.linalg at config 3's X, cholesky at 8192^2 and eigh/svd/"
        "inv/slogdet at 4096^2, sp.fft and Poisson's spectral solve at "
        "16384^2, sp.random's distributions, array files")
  HOST_SPANS.clear()
  counted = phase_namespaces(device, card)
  k3["spmv_csr"]["launches"] += counted["csr"]
  k3["spmv_ell"]["launches"] += counted["ell"]
  k1["launches"] += counted["k1"]
  print_host_spans(20, done(20))
  print("phase 21: the spectral solvers of sp.sparse.linalg through K3a/K3b "
        "(eigsh on the 2048^2 and 128 x 256 grids' Laplacians, by shift-"
        "invert too, eigs on convection-diffusion, svds of MovieLens 20M's "
        "shape, expm_multiply at 2^22), LaplacianNd, the densified and host "
        "functions, and sp.scipy_linalg at 4096^2 float64")
  HOST_SPANS.clear()
  spectral, ratings, svds_s = phase_spectral(device, card)
  k3["spmv_ell"]["launches"] += spectral["ell"]
  k3["spmv_csr"]["launches"] += spectral["csr"]
  print_host_spans(21, done(21))
  print("phase 22: autodiff and sp.sparse.csgraph at full width: sp.compile "
        "through K1 (config 1) and K3b (a PageRank step at 2^22), grad/"
        "value_and_grad/hvp/hessian/jvp at config 3's shape, through SpMV "
        "and SpMM, minimize, convnet's training with remat, dijkstra/"
        "components/laplacian on urand 2^22, floyd_warshall")
  autodiff = phase_autodiff_csgraph(device, card, urand, urand_ranks,
                                    k1["ms"], oracles22)
  del urand, urand_ranks
  k1["launches"] += autodiff["k1"]
  k3["spmv_csr"]["launches"] += autodiff["csr"]
  done(22)
  gc.collect()
  torch.cuda.empty_cache()
  print("phase 23: sp.optimize and sp.integrate in float64: curve_fit and "
        "least_squares (lm, trf in a box) over 2^20 samples, BFGS and the "
        "box solver on a 64-parameter Rosenbrock, root of 256 unknowns, "
        "brentq/ridder/bisect/newton on 0-d tensors, differential_evolution "
        "on 8-D Rastrigin, Nelder-Mead, solve_ivp RK45/RK23 of a 65,536-"
        "unknown heat equation, the sampled rules over 2^24 + 1 samples, "
        "fixed_quad/tanhsinh/qmc_quad")
  phase_optimize_integrate(device, card, oracles23)
  done(23)
  gc.collect()
  torch.cuda.empty_cache()
  print("phase 24: the remaining examples through learn's 14 estimators at "
        "full width (the regressions at config 3's shape, the clustering at "
        "config 4's, k-NN, naive Bayes, netflix SGD at MovieLens 20M's "
        "shape, ALS and TruncatedSVD on phase 21's ratings through K5a and "
        "K3a/K3b, Black-Scholes on 2^26 options), sp.special's 116 device "
        "names at 2^24 points, and the examples' CLI")
  learned = phase_learn_special(device, card, oracles24, procs, ratings,
                                svds_s)
  del ratings, svds_s
  k5["launches"] += learned["k5"]
  k3["spmv_ell"]["launches"] += learned["ell"]
  k3["spmv_csr"]["launches"] += learned["csr"]
  done(24)
  gc.collect()
  torch.cuda.empty_cache()
  print("phase 25: sp.stats and sp.signal at full width: every method of "
        "the 24 device distributions at 2^22 float64 points and their "
        "draws, the descriptive statistics on 2^14 x 2^10 along each axis, "
        "the hypothesis tests on 2^20 samples, gaussian_kde at 2^16 points, "
        "the convolutions, spectra and filters at 2^20-2^22 samples, "
        "lfilter/filtfilt/sosfilt/sosfiltfilt/decimate on 256 channels, and "
        "the oscillator example")
  phase_stats_signal(device, card, oracles25)
  done(25)
  gc.collect()
  torch.cuda.empty_cache()
  print("phase 26: sp.ndimage and sp.spatial at full width: gaussian, "
        "uniform, median, sobel and 3x3/5x5 correlate on an 8192^2 float32 "
        "image, a 256^3 Gaussian, the 3x3 correlate timed at 16384^2; "
        "opening, fill_holes and label of 8192^2 blobs and the measurements "
        "over every label (sum_labels without labels through K1); zoom, "
        "rotate and 2^22-point map_coordinates on 4096^2; cdist of 8192^2 x "
        "64, a KDTree's 8 nearest among 2^18 points, Rotation over 2^20")
  nd26 = phase_ndimage_spatial(device, card, oracles26)
  procs.shutdown()
  k1["launches"] += nd26["k1"]
  done(26)
  print(f"  total wall {time.perf_counter() - t_start:.2f} s after phase 0")

  rows = [("fused_sum", "fused_reduce.cu",
           "spartan_tpu/backend/kernels/fused_reduce.py:65", k1),
          ("spmv_ell", "spmv_ell.cu",
           "spartan_tpu/backend/kernels/spmv_pallas.py:106", k3["spmv_ell"]),
          ("spmv_csr", "spmv_csr.cu",
           "spartan_tpu/backend/kernels/spmv_pallas.py:657", k3["spmv_csr"]),
          ("spmm_csr", "spmm_csr.cu",
           "spartan_tpu/backend/kernels/spmm_pallas.py:232", k5),
          ("stencil3x3", "stencil3x3.cu",
           "spartan_tpu/backend/kernels/stencil_pallas.py:73", k4),
          ("stencil3x3_padded", "stencil3x3_padded.cu",
           "spartan_tpu/backend/kernels/stencil_pallas.py:298", k6a),
          ("matmul", "matmul.cu",
           "spartan_tpu/backend/kernels/matmul.py:55", k2_row),
          ("spmv_chunked", "spmv_chunked.cu",
           "spartan_tpu/backend/kernels/spmv_pallas.py:742", k3c),
          ("sharded_onehot_spmv", "spmv_ell.cu",
           "spartan_tpu/backend/kernels/spmv_pallas.py:136",
           sharded["sharded_onehot_spmv"]),
          ("sharded_windowed_spmv", "spmv_csr.cu",
           "spartan_tpu/backend/kernels/spmv_pallas.py:888",
           sharded["sharded_windowed_spmv"]),
          ("sharded_windowed_spmm", "spmm_csr.cu",
           "spartan_tpu/backend/kernels/spmm_pallas.py:383",
           sharded["sharded_windowed_spmm"]),
          ("stencil3x3_padded_sharded", "stencil3x3_padded.cu",
           "spartan_tpu/backend/kernels/stencil_pallas.py:387",
           sharded["stencil3x3_padded_sharded"])]
  print(json.dumps({"kernels": [
      {"name": name, "route": "cuda",
       "source": f"spartan_tpu_torch/csrc/{source}", "replaces": replaces,
       **{key: row[key] for key in ("launches", "max_abs_err", "ms",
                                    "plain_ms", "bound_ms", "bound_by",
                                    "library_ms")}}
      for name, source, replaces, row in rows]}))
  print(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
  main()
