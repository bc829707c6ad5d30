"""PyTorch / CUDA port of the SAR-SSL framework for NVIDIA Hopper (H100).

The JAX package ``sarssl_tpu`` is the reference this package is held
against. Module names mirror it (``ops``, ``kernels``, ``models``, ``train``,
``utils``, ``data``) so each counterpart is easy to find. Nothing here imports
JAX or ``sarssl_tpu``.

Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"``; with no GPU and no explicit CPU they raise.
"""
