"""Kernels and their plain versions (counterpart of vivqa_tpu/ops)."""
