"""Placement-solver ops in PyTorch: counterparts of ``rio_tpu/ops``.

Placement is a batched assignment problem: an (objects x nodes) cost
matrix built from liveness and load, an entropic optimal-transport
(Sinkhorn) solve, capacity-aware rounding and an exact-quota repair.

Each name is its ``rio_tpu.ops`` counterpart's, except for the kernel path:

==============================  =========================================
``rio_tpu_torch.ops``           ``rio_tpu.ops``
==============================  =========================================
``fused_scaling_iteration``     ``fused_scaling_iteration`` (Pallas; here
                                a CUDA kernel, plain twin
                                ``fused_scaling_iteration_ref``)
``fused_scaling_core``          ``pallas_scaling_core``
``fused_scaling_sinkhorn``      ``pallas_scaling_sinkhorn``
``scaling_impl_for``            ``scaling_impl_for`` (takes a device)
``fused_iteration``             ``fused_iteration`` (Pallas; here a CUDA
                                kernel, plain twin ``fused_iteration_ref``)
``pallas_sinkhorn``             ``pallas_sinkhorn`` (no ``block_rows`` or
                                ``interpret``: nothing is padded)
==============================  =========================================
"""

from .assignment import (
    assign_from_potentials,
    build_cost_matrix,
    greedy_balanced_assign,
    integer_fair_quotas,
    residual_capacity_assign,
)
from .pallas_sinkhorn import fused_iteration, fused_iteration_ref, pallas_sinkhorn
from .scaling import (
    fused_scaling_core,
    fused_scaling_iteration,
    fused_scaling_iteration_ref,
    fused_scaling_sinkhorn,
    scaling_core,
    scaling_core_auto,
    scaling_impl_for,
    scaling_sinkhorn,
)
from .sinkhorn import (
    SinkhornResult,
    exact_quota_repair,
    plan_rounded_assign,
    plan_rounded_assign_from_scaling,
    sinkhorn,
    sinkhorn_assign,
)

__all__ = [
    "SinkhornResult",
    "fused_iteration",
    "fused_iteration_ref",
    "pallas_sinkhorn",
    "fused_scaling_core",
    "fused_scaling_iteration",
    "fused_scaling_iteration_ref",
    "fused_scaling_sinkhorn",
    "scaling_core",
    "scaling_core_auto",
    "scaling_impl_for",
    "scaling_sinkhorn",
    "assign_from_potentials",
    "build_cost_matrix",
    "greedy_balanced_assign",
    "integer_fair_quotas",
    "residual_capacity_assign",
    "exact_quota_repair",
    "plan_rounded_assign",
    "plan_rounded_assign_from_scaling",
    "sinkhorn",
    "sinkhorn_assign",
]
