"""Weight protection of the port: schemes, backends, policy, plan, the
decode-at-use view, the host trial pipeline and the fault campaigns
(counterpart of ``repro.protection``)."""
from .backends import BACKENDS, Backend, get_backend  # noqa: F401
from .campaign import (CampaignResult, accuracy_eval,  # noqa: F401
                       compute_campaign, due_campaign, due_eval,
                       fidelity_campaign, fidelity_eval, run_campaign,
                       run_campaign_host)
from .host import (HostScheme, Stored, get_host_scheme,  # noqa: F401
                   run_fault_trial)
from .plan import LeafPlan, ProtectionPlan, ShapeDtype, make_plan  # noqa: F401
from .policy import (CoverageEntry, CoverageReport,  # noqa: F401
                     ProtectionPolicy, decode_leaf, decode_leaf_with_flags,
                     decode_tree, decode_tree_with_flags, inject_tree,
                     inject_tree_device, space_overhead)
from .schemes import (ALIASES, SCHEMES, Faulty, InPlace,  # noqa: F401
                      ParityZero, Scheme, Secded72, get_scheme, scheme_ids)
from .tensor import ProtectedTensor, is_protected_tensor  # noqa: F401


def coverage(params, policy=None):
    """What ``policy`` (default: in-place on every weight) does to every
    leaf of ``params``, without encoding anything."""
    return (policy or ProtectionPolicy()).coverage(params)
