from repro_torch.optim.optimizers import (Optimizer, adam, adamw,
                                          apply_updates, clip_by_global_norm,
                                          get, global_norm, rmsprop, sgd,
                                          tree_map)
from repro_torch.optim import schedules  # noqa: F401
