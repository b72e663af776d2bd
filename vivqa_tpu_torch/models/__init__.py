"""Models of the port (counterpart of vivqa_tpu/models)."""
