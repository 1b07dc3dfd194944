"""The benchmark scripts of the port, the counterparts of the reference's
``benchmarks/``: the paper's experiments (``fault_injection``,
``weight_distribution``, ``wot_training``, ``wot_admm_compare``), the
burst grid (``burst_sim``), the kernel micro-benchmarks and autotune
artifact (``kernel_bench``), the dry-run rooflines (``roofline``,
``report``) and the runner (``run``):
``python -m repro_torch.benchmarks.<name>``."""
