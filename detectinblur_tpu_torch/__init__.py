"""PyTorch + CUDA port of the detectinblur_tpu serving path.

Modules mirror the JAX package's paths (``ops/``, ``models/``, ``data/``,
``utils/``) so each counterpart is found by name. Public functions keep
the JAX package's layouts (NHWC images, ``[B, H, W, C]`` FPN levels,
padded arrays with ``valid`` masks) so that parity tests compare like with
like. Entry points run on CUDA unless the caller passes ``device="cpu"``.

Nothing here imports JAX or the JAX package, and no CUDA code is built or
loaded at import time: kernels build from ``csrc/`` on first use.
"""
