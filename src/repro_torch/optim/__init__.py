from .adamw import (AdamWConfig, adamw_init, adamw_update, cosine_lr,
                    opt_state_specs)

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "cosine_lr",
           "opt_state_specs"]
