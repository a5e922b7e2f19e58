"""PyTorch + CUDA port of detectinblur_tpu: blur synthesis, Faster R-CNN
ResNet50-FPN inference and training, COCO evaluation and the ``train`` and
``evaluate`` command lines.

Modules mirror the JAX package's paths (``ops/``, ``models/``, ``data/``,
``eval/``, ``train/``, ``parallel/``, ``cli/``, ``utils/``) so each
counterpart is found by name. Public functions keep
the JAX package's layouts (NHWC images, ``[B, H, W, C]`` FPN levels,
padded arrays with ``valid`` masks) so that parity tests compare like with
like. Entry points run on CUDA unless the caller passes ``device="cpu"``.

Nothing here imports JAX or the JAX package, and no CUDA code is built or
loaded at import time: kernels build from ``csrc/`` on first use.
"""
