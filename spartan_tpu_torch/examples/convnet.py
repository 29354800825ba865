"""A small convolutional network's forward pass, port of the forward part
of ``spartan_tpu/examples/convnet.py``: conv → relu → pool → conv → relu →
pool → flatten → dense, on the stencil and maxpool exprs, NCHW.  Training
(``loss_expr``, ``train_step``, ``train``, ``fit_fused``) needs autodiff
and comes with it.
"""

from __future__ import annotations

import numpy as np

import spartan_tpu_torch as sp


def init_params(in_ch: int = 1, c1: int = 8, c2: int = 16,
                n_classes: int = 10, img: int = 28, seed: int = 0):
  rng = np.random.default_rng(seed)
  flat = c2 * (img // 4) * (img // 4)
  scale = 0.1
  return {
      "w1": rng.standard_normal((c1, in_ch, 3, 3)) * scale,
      "w2": rng.standard_normal((c2, c1, 3, 3)) * scale,
      "wd": rng.standard_normal((flat, n_classes)) * scale,
      "bd": np.zeros(n_classes),
  }


def relu(v):
  return sp.maximum(v, 0.0)


def forward(images, params):
  """images: (N, C, H, W) → logits (N, n_classes), fully lazy."""
  x = sp.lazify(images)
  n = x.shape[0]
  h1 = sp.maxpool(relu(sp.stencil(x, sp.lazify(params["w1"]))), 2)
  h2 = sp.maxpool(relu(sp.stencil(h1, sp.lazify(params["w2"]))), 2)
  flat = h2.reshape(n, int(np.prod(h2.shape[1:])))
  return sp.dot(flat, sp.lazify(params["wd"])) + sp.lazify(params["bd"])


def predict(images, params):
  return sp.argmax(forward(images, params), axis=1)


def run(n: int = 32, img: int = 28, seed: int = 0):
  rng = np.random.default_rng(seed)
  images = rng.standard_normal((n, 1, img, img))
  params = init_params(img=img, seed=seed)
  logits = forward(sp.from_numpy(images), params)
  return logits.evaluate(), params, images
