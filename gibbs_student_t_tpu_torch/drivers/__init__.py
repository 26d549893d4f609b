"""Command-line drivers of the port, the JAX package's two scripts:

    python -m gibbs_student_t_tpu_torch.drivers.simulate_data ...
    python -m gibbs_student_t_tpu_torch.drivers.run_sims ...

Both run on the GPU unless ``--device cpu`` is given, and exit non-zero
when CUDA is absent and the CPU was not asked for.
"""
