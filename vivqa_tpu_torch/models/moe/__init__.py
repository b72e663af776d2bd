"""Mixture-of-experts layers and routers (counterpart of vivqa_tpu/models/moe)."""
