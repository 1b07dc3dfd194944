"""Distribution of the port: the sharding rules and their DTensor
placements (``sharding``), shard-local execution of the kernels and the
collectives sharding needs (``local``), and GPipe pipeline stages
(``pipeline``). Counterpart of ``repro.distributed``."""
from . import sharding  # noqa: F401
