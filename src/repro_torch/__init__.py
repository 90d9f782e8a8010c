"""Lynceus in PyTorch and CUDA: the port of the JAX package ``repro``.

Module paths mirror ``repro``'s one to one (``repro.core.trees`` ->
``repro_torch.core.trees``), and each function is held against the
``repro`` function of the same name: the decision path bit for bit.  The
package imports torch and numpy, never jax and never ``repro``.

Entry points (``core.optimize``, ``core.run_many``, ``core.make_selector``,
``core.make_batch_selector``) run on the card by default and take
``device="cpu"`` to run the plain PyTorch path on the CPU.
"""
