"""Hand-written Hopper kernels of the port (``csrc/*.cu``, built by
:mod:`._build` at first use) with their plain PyTorch versions
(:mod:`.ref`) and the device dispatch (:mod:`.ops`).

K1 ``paged_attention`` replaces the TPU ``_paged_kernel``; K2
``flash_attention`` replaces the TPU ``_flash_kernel``; K4 ``lsdnn_layer``
replaces the TPU ``_lsdnn_kernel``.
"""
