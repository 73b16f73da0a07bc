from repro_torch.optim.adamw import AdamW, AdamWState, apply_updates, cosine_schedule, global_norm

__all__ = ["AdamW", "AdamWState", "apply_updates", "cosine_schedule", "global_norm"]
