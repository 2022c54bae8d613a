"""The float64 polish engine, on the card.

Counterpart of ``qsfh_tpu/native/``.  There the JAX package compiles host
C++ (``statevec64.cpp``) for the flagship's float64 L-BFGS / Newton-CG
polish of a rot program, and a C++ merge and single-string dressing
(``pauli_native.cpp``) that ``PauliSum.simplify`` and ``dress_once`` switch
to from 2048 terms.  Here :mod:`qsfh_torch.native.statevec` runs the same
grouped float64 program on the card, through hand-written CUDA kernels
(``rot64_groups``, ``happly64``, ``adjoint64_groups`` in
``qsfh_torch/csrc/statevec_kernels.cu``), not on the host; the merge and
dressing stay the numpy code of ``qsfh_torch.ops.pauli`` and
``qsfh_torch.ops.dressing`` (the JAX package's own fallback path), which
give the native path's terms in the same order.
"""
