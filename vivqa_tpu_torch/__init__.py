"""PyTorch port of vivqa_tpu for one NVIDIA H100 (Hopper, sm_90a).

Mirrors the JAX package's layout and names. It imports torch, never jax,
and nothing of ``vivqa_tpu``. Entry points run on the card unless the
caller passes ``device="cpu"``; on the CPU every kernel's plain version
runs instead. See README.md, "The PyTorch port".
"""
