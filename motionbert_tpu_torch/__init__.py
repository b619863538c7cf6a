"""motionbert_tpu_torch: the PyTorch and CUDA port of motionbert_tpu.

The serving path of the flagship DSTformer (``api.MotionBERT``,
``serve.MotionBERTServer``) runs on an NVIDIA GPU, its attention+MLP pairs
through hand-written CUDA kernels (``ops/csrc/``). The package imports torch,
never jax, and nothing of ``motionbert_tpu``.
"""
