"""sklearn-flavoured estimator API (port of ``spartan_tpu/learn``): thin ``fit``/``predict``/``transform``
estimator classes over :mod:`spartan_tpu_torch.examples`, accepting numpy /
SpartanArray / lazy-expr inputs.
"""

from spartan_tpu_torch.learn.estimators import (ALS, FuzzyKMeans, GaussianMixture,
                                          KMeans, KNeighborsClassifier, Lasso,
                                          LinearRegression,
                                          LogisticRegression, NaiveBayes,
                                          PCA, Ridge, SpectralClustering, SVC,
                                          TruncatedSVD)

__all__ = ["ALS", "FuzzyKMeans", "GaussianMixture", "KMeans",
           "KNeighborsClassifier", "Lasso",
           "LinearRegression",
           "LogisticRegression", "NaiveBayes", "PCA", "Ridge",
           "SpectralClustering", "SVC", "TruncatedSVD"]
