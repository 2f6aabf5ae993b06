"""uig_torch: the PyTorch + CUDA port of uig for NVIDIA Hopper.

The JAX package ``uig`` stays the reference; this package imports ``torch``
and never ``jax`` or ``uig``. So far it serves the CycleGAN ResNet generator:
``uig_torch.serving.Translator`` (uint8 in, uint8 out), the HTTP
micro-batcher in ``uig_torch.serve`` and ``python -m uig_torch.cli``.
Entry points run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``, where every kernel wrapper runs its plain PyTorch version.
"""
