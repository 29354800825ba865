"""Example workloads (port of ``spartan_tpu/examples/``).

Each module exposes a library-style entry that returns the fitted model,
built from the lazy expression API.  Every reference example is here but
``oscillator``, which waits for ``sp.signal``; ``python -m
spartan_tpu_torch.examples <name>`` runs one (``__main__``).
"""

from spartan_tpu_torch.examples import (als, cg, convnet, fuzzy_kmeans,
                                        kmeans, linear_reg, logistic_reg,
                                        naive_bayes, netflix_sgd, pagerank,
                                        pca, ridge_reg, svm)
