"""egot2x on PyTorch and CUDA (NVIDIA Hopper).

A port of the JAX package ``egot2x`` that stays beside it as the
reference. Entry point: :func:`egot2x_torch.core.registry.build_model`.
"""
