"""Training: loss, optimizer and the train step (counterpart of
vivqa_tpu/train)."""
