"""Weight protection of the port: schemes, backends, policy, plan and the
decode-at-use view (counterpart of ``repro.protection``)."""
from .backends import BACKENDS, get_backend  # noqa: F401
from .plan import ProtectionPlan, ShapeDtype, make_plan  # noqa: F401
from .policy import (ProtectionPolicy, decode_leaf_with_flags,  # noqa: F401
                     inject_tree_device)
from .schemes import ALIASES, get_scheme, scheme_ids  # noqa: F401
from .tensor import ProtectedTensor, is_protected_tensor  # noqa: F401
