from repro_torch.optim.optimizers import (Optimizer, adam, adamw,
                                          apply_updates, clip_by_global_norm,
                                          get, global_norm, rmsprop, sgd,
                                          tree_map)
# leaves in the reference's order (sorted dict keys)
from repro_torch.optim.optimizers import _leaves as leaves  # noqa: F401
from repro_torch.optim import schedules  # noqa: F401
