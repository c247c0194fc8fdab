"""Multi-device editing over ``torch.distributed`` (dp, tp, sp)."""
