"""Numerics of the sweep: TNT products, preconditioned Cholesky algebra,
and the wrappers of the CUDA kernels (chol, tnt, white_mh with its MTM
form, hyper_mh) with their plain PyTorch versions."""
