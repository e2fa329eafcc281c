"""PyTorch/CUDA port of lifelong_clip_tpu for NVIDIA Hopper GPUs.

Mirrors the JAX package's module tree; imports torch, never jax, and
nothing of ``lifelong_clip_tpu``. Entry points run on ``cuda`` unless the
caller asks for the CPU.
"""
