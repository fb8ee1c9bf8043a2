"""PyTorch/CUDA port of fl4health_tpu: federated training on an NVIDIA card.

The JAX package ``fl4health_tpu`` stays the reference; this package mirrors
its module paths (``core``, ``kernels``, ``models``, ``clients``,
``metrics``, ``exchange``, ``strategies``, ``server``, ``datasets``) and
imports neither JAX nor anything of ``fl4health_tpu``.
"""
