"""Host-side data handling (copies from vivqa_tpu/data)."""
