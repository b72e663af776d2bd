"""Inference (counterpart of vivqa_tpu/eval)."""
