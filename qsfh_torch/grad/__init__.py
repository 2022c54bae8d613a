"""Gate-level adjoint differentiation (the unrolled cross-check lowering)."""

from .adjoint import adjoint_apply, build_adjoint_energy, givens_network_ops

__all__ = ["adjoint_apply", "build_adjoint_energy", "givens_network_ops"]
