"""Weight protection of the port: schemes, backends, policy, plan, the
decode-at-use view, the host trial pipeline, the fault campaigns and MILR
repair (counterpart of ``repro.protection``)."""
from .backends import (BACKEND_ALIASES, BACKENDS,  # noqa: F401
                       AutotuneTable, Backend, get_backend)
from .campaign import (CampaignResult, accuracy_eval,  # noqa: F401
                       compute_campaign, due_campaign, due_eval,
                       fidelity_campaign, fidelity_eval, run_campaign,
                       run_campaign_host)
from .host import (HostScheme, Stored, get_host_scheme,  # noqa: F401
                   run_fault_trial)
from .plan import (POLICY_PRESETS, LeafDiff, LeafPlan,  # noqa: F401
                   PlanDiff, ProtectionPlan, ShapeDtype, get_policy_preset,
                   make_plan, transcode_leaf)
from .policy import (CoverageEntry, CoverageReport,  # noqa: F401
                     ProtectionPolicy, decode_leaf, decode_leaf_with_flags,
                     decode_tree, decode_tree_with_flags, inject_tree,
                     inject_tree_device, space_overhead,
                     spec_tree)
from .schemes import (ALIASES, SCHEMES, Faulty, InPlace,  # noqa: F401
                      ParityZero, Scheme, Secded72, get_scheme, scheme_ids)
from .tensor import ProtectedTensor, is_protected_tensor  # noqa: F401


from .repair import (LeafKit, RepairKit, build_repair_kit,  # noqa: F401
                     due_block_mask, repair_leaf, repair_tree)

_DEFAULT_POLICY = None


def default_policy() -> ProtectionPolicy:
    """The serving default: in-place zero-space ECC on every weight
    tensor, pad-and-protect, the plain route."""
    global _DEFAULT_POLICY
    if _DEFAULT_POLICY is None:
        _DEFAULT_POLICY = ProtectionPolicy()
    return _DEFAULT_POLICY


def encode_tree(params, policy=None):
    """Encode a parameter tree under ``policy`` (default:
    :func:`default_policy`); decoding needs no policy, each
    ``ProtectedTensor`` carries its scheme id."""
    return (policy or default_policy()).encode_tree(params)


def coverage(params, policy=None):
    """What ``policy`` (default: in-place on every weight) does to every
    leaf of ``params``, without encoding anything."""
    return (policy or default_policy()).coverage(params)
