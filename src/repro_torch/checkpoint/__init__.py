from repro_torch.checkpoint.ckpt import latest_step, manifest, restore, save

__all__ = ["latest_step", "manifest", "restore", "save"]
