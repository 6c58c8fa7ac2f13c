"""The optimizer of the port's trainer (``repro.optim``'s counterpart)."""
from .adamw import (AdamWState, adamw_init, adamw_update, global_norm,
                    lr_schedule)

__all__ = ["AdamWState", "adamw_init", "adamw_update", "global_norm",
           "lr_schedule"]
