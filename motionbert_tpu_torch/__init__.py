"""motionbert_tpu_torch: the PyTorch and CUDA port of motionbert_tpu.

The serving path of the flagship DSTformer (``api.MotionBERT``,
``serve.MotionBERTServer``) and its pose3d training (``train.pose3d``) run on
an NVIDIA GPU, the attention+MLP pairs forward and backward through
hand-written CUDA kernels (``ops/csrc/``). The package imports torch,
never jax, and nothing of ``motionbert_tpu``.
"""
