"""PyTorch and CUDA port of qsfh_tpu for NVIDIA Hopper GPUs.

The JAX package ``qsfh_tpu`` is the reference; this package keeps its
module paths and names (``qsfh_torch.algos.adapt.ADAPT`` mirrors
``qsfh_tpu.algos.adapt.ADAPT``) and imports neither JAX nor ``qsfh_tpu``.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
