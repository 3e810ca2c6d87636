"""karpenter_tpu_torch: the provisioning solver of karpenter_tpu on PyTorch
and CUDA.

The feasibility precompute of the provisioning solve runs as hand-written
CUDA kernels for Hopper (ops/kernels.py, ops/csrc/); the host half — encode,
the grouped packer, the host oracle, the API types — is this package's own
copy of the JAX package's jax-free modules, held equal to them by the parity
tests. Entry points run on ``cuda`` unless the caller asks for ``"cpu"``.
"""

__version__ = "0.1.0"
