"""The paper's experiment scripts of the port (counterparts of the
reference's ``benchmarks/fault_injection.py``, ``weight_distribution.py``
and ``wot_training.py``): ``python -m repro_torch.benchmarks.<name>``."""
