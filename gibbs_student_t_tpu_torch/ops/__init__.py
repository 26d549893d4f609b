"""Numerics of the sweep: TNT products, preconditioned Cholesky algebra,
and the wrappers of the CUDA kernels (chol, white_mh, hyper_mh) with their
plain PyTorch versions."""
