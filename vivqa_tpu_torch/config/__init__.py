"""Config mixin (copy of vivqa_tpu/config)."""
