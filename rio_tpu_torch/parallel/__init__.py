"""Scale-out solves of the port: counterpart of ``rio_tpu/parallel``.

Only the single-device two-level solve is here
(:mod:`rio_tpu_torch.parallel.hierarchical`). The mesh-sharded solves of
the JAX package (``make_mesh``, ``sharded_*``, ``mesh_chunked_*``) belong
to ROADMAP A.11.
"""

from .hierarchical import (
    HierarchicalResult,
    chunked_hierarchical_assign,
    chunked_hierarchical_assign_timed,
    hierarchical_assign,
)

__all__ = [
    "HierarchicalResult",
    "chunked_hierarchical_assign",
    "chunked_hierarchical_assign_timed",
    "hierarchical_assign",
]
