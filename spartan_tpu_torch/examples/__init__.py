"""Example workloads ported so far: ``linear_reg``, ``logistic_reg``,
``kmeans``, ``pagerank``, ``als``, ``heat``, ``poisson``, ``convnet``."""
