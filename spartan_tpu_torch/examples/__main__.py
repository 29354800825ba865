"""CLI example runner: ``python -m spartan_tpu_torch.examples <name> [flags]``
(port of ``spartan_tpu/examples/__main__.py``).

One entry point runs any example on the default mesh, with the framework
flags (``--device=cpu``, ``--mesh_shape``, ...) passed to
``sp.initialize``: the card is the default device.  Each runner returns a
dict with the reference's keys; ``main`` adds ``seconds``, ``example`` and
``mesh`` and prints it.
"""

from __future__ import annotations

import sys
import time

import numpy as np

import spartan_tpu_torch as sp

_RUNNERS = {}

# reference runners that wait for a module the port lacks, with the reason;
# the PR that ports the module registers the runner and takes it off here
WAITING = ()


def _register(name):
  def deco(fn):
    _RUNNERS[name] = fn
    return fn
  return deco


@_register("oscillator")
def _oscillator():
  from spartan_tpu_torch.examples import oscillator
  got, want = oscillator.run()
  return {"recovered_hz": got, "expected_hz": want,
          "rel_err": abs(got - want) / want}


@_register("linreg")
def _linreg():
  from spartan_tpu_torch.examples import linear_reg
  w, w_true = linear_reg.run(8192, 32, 100)
  return {"max_err": float(np.abs(w.glom() - w_true).max())}


@_register("logreg")
def _logreg():
  from spartan_tpu_torch.examples import logistic_reg
  _, acc = logistic_reg.run(8192, 32, 80)
  return {"accuracy": float(acc)}


@_register("kmeans")
def _kmeans():
  from spartan_tpu_torch.examples import kmeans
  centers, labels, true_centers = kmeans.run(8192, 16, 8, 15)
  return {"centers_shape": list(centers.shape)}


@_register("pagerank")
def _pagerank():
  from spartan_tpu_torch.backend import sparse as sps
  from spartan_tpu_torch.examples import pagerank
  M = pagerank.make_link_matrix(1024)
  r = pagerank.fit_sparse(sps.from_dense(M), 50)
  return {"rank_sum": float(np.sum(r))}


@_register("cg")
def _cg():
  from spartan_tpu_torch.examples import cg
  x, x_true = cg.run(512, 200)
  return {"max_err": float(np.abs(x.glom() - x_true).max())}


@_register("pca")
def _pca():
  from spartan_tpu_torch.examples import pca
  comps, evals, _ = pca.run(8192, 32, 4)
  return {"evals": [float(e) for e in evals]}


@_register("svm")
def _svm():
  from spartan_tpu_torch.examples import svm
  _, acc = svm.run(8192, 16, 150)
  return {"accuracy": float(acc)}


@_register("naive_bayes")
def _nb():
  from spartan_tpu_torch.examples import naive_bayes
  return {"accuracy": float(naive_bayes.run(8192, 32, 5))}


@_register("als")
def _als():
  from spartan_tpu_torch.examples import als
  _, _, err = als.run(512, 256, 12, 10)
  return {"mse": float(err)}


@_register("fuzzy_kmeans")
def _fkm():
  from spartan_tpu_torch.examples import fuzzy_kmeans
  centers, u, _ = fuzzy_kmeans.run(4096, 8, 5)
  return {"centers_shape": list(np.asarray(centers.glom()).shape)}


@_register("netflix")
def _netflix():
  from spartan_tpu_torch.examples import netflix_sgd
  return {"rmse": float(netflix_sgd.run(512, 256, 8, 16384, 5))}


@_register("ridge")
def _ridge():
  from spartan_tpu_torch.examples import ridge_reg
  w, _ = ridge_reg.run(4096, 16, 1e-3)
  return {"w_norm": float(np.linalg.norm(np.asarray(w)))}


@_register("black_scholes")
def _black_scholes():
  from spartan_tpu_torch.examples import black_scholes
  call, put = black_scholes.run(1 << 16)
  return {"mean_call": float(np.mean(np.asarray(call.glom()))),
          "mean_put": float(np.mean(np.asarray(put.glom())))}


@_register("lanczos")
def _lanczos():
  from spartan_tpu_torch.examples import lanczos
  est, true = lanczos.run(512, 40)
  return {"top_eig_est": est, "top_eig_true": true}


@_register("cholesky")
def _cholesky():
  from spartan_tpu_torch.examples import cholesky
  _, err = cholesky.run(512, 128)
  return {"max_err_vs_numpy": err}


@_register("qr")
def _qr():
  from spartan_tpu_torch.examples import qr
  orth_err, recon_err = qr.run(1 << 14, 32)
  return {"orth_err": orth_err, "recon_err": recon_err}


@_register("convnet")
def _convnet():
  from spartan_tpu_torch.examples import convnet
  rng = np.random.default_rng(0)
  images = rng.standard_normal((64, 1, 16, 16))
  labels = rng.integers(0, 10, 64)
  _, losses = convnet.fit_fused(images, labels, epochs=3)
  return {"losses": [round(float(l), 4) for l in losses]}


@_register("heat")
def _heat():
  from spartan_tpu_torch.examples import heat
  err, total = heat.run(256, 200)
  return {"max_err_vs_numpy": err, "heat_total": total}


@_register("poisson")
def _poisson():
  from spartan_tpu_torch.examples import poisson
  res, ustd = poisson.run(256)
  return {"poisson_residual": res, "u_std": ustd}


@_register("lasso")
def _lasso():
  from spartan_tpu_torch.examples import lasso
  w, w_oracle, w_true = lasso.run(8192, 32)
  return {"max_err_vs_numpy_fista": float(np.abs(w - w_oracle).max()),
          "nnz": int((np.abs(w) > 1e-12).sum())}


@_register("spectral")
def _spectral():
  from spartan_tpu_torch.examples import spectral
  return {"rings_accuracy": spectral.run(512)}


@_register("gmm")
def _gmm():
  from spartan_tpu_torch.examples import gmm
  err, pi = gmm.run(4096, 4, 3, 40)
  return {"gmm_mean_recovery_err": err, "weights": [round(float(p), 4) for p in pi]}


@_register("knn")
def _knn():
  from spartan_tpu_torch.examples import knn
  return {"accuracy": knn.run()}


def main(argv):
  rest = [a for a in argv if not a.startswith("--")]
  flags = [a for a in argv if a.startswith("--")]
  if not rest or rest[0] not in _RUNNERS:
    print(f"usage: python -m spartan_tpu_torch.examples <{('|'.join(sorted(_RUNNERS)))}> "
          "[--framework-flags]")
    return 1
  sp.initialize(flags)
  name = rest[0]
  t0 = time.perf_counter()
  out = _RUNNERS[name]()
  out["seconds"] = round(time.perf_counter() - t0, 3)
  out["example"] = name
  out["mesh"] = dict(sp.get_mesh().shape)
  print(out)
  return 0


if __name__ == "__main__":
  sys.exit(main(sys.argv[1:]))
