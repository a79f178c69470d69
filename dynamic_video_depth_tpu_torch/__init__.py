"""PyTorch + CUDA port of ``dynamic_video_depth_tpu`` for NVIDIA Hopper.

The JAX package beside this one is the reference; every module here has its
counterpart at the same path there and is held to it by the
``tests/test_torch_*.py`` parity tests. This package imports ``torch`` and
never ``jax`` (nor the JAX package, whose ``data`` subpackage pulls jax in).

Layout mirrors the JAX package: ``ops`` (geometry, warp, embedding and the
hand-written CUDA kernels under ``ops/cuda`` + ``csrc``), ``models``,
``train`` (the step, the loop and the train entry), ``data``, ``runtime``
(options, checkpoints, loggers, weights, the device), ``utils`` (colouring,
visualization, metrics), ``preprocess`` and the test entry ``test``.
"""
