"""Measurement tools of the port (counterparts of the root ``tools/``):

- ``profile_components``: the flagship classification step by component
  (full step, forward, eval forward, forward + backward, optimizer);
- ``profile_towers``: forward and forward + backward of each tower alone;
- ``bench_input_pipeline``: images/s of the PIL and native loaders.

Each runs as ``python3 -m vivqa_tpu_torch.tools.<name>``, on the card
unless given ``--device cpu``, and prints the JAX tool's lines and one
JSON line.
"""
